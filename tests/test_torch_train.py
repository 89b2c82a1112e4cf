"""The port's training stack against the JAX package's, on the CPU.

- ``Adam``/``AdamW`` steps on the same parameters and gradients against
  ``paddle_tpu.optimizer``: float32 parameters and moments at
  rtol = 1e-6, atol = 1e-7 after three steps (the same float32 rule;
  PyTorch may fuse ``a + alpha * b`` into one rounding where XLA rounds
  twice, one ulp), with ``multi_precision`` on bf16 parameters (float32
  masters at the same tolerance, the bf16 parameters within one bf16
  step of each other), and with ``apply_decay_param_fun``.
- ``TrainStep`` on the flash-eligible small GPT against JAX's
  ``TrainStep`` in float32, ``steps_per_call`` 1 and 2: losses at
  rtol = 1e-5 and the parameters after the steps at atol = 2 lr
  (2e-5). Adam normalises each update to about ``lr`` whatever the
  gradient's size, so where a gradient is near zero a difference in its
  last bits can move the parameter by up to ``lr`` either way: 2 lr is
  one such flip, the parameters themselves move by up to lr a step.
- The AMP O2 bf16 path for two steps: losses at 2e-2 relative (bf16
  activations, a step of 3.9e-3 relative, rounded at different points by
  the two backends); bf16 gradients differ by about 1e-2 relative, so a
  near-zero one may flip in each step: the float32 master weights at
  atol = 2 lr per step (4e-5), the bf16 parameters within two bf16
  steps plus that.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.text import gpt as jgpt  # noqa: E402
from paddle_tpu_torch.amp import decorate  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.optimizer import Adam, AdamW  # noqa: E402
from paddle_tpu_torch.text import gpt as tgpt  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
LR = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 2 * LR
BF16_LOSS_RTOL = 2e-2

SHAPES = {"w.weight": (16, 24), "w.bias": (24,), "ln.weight": (24,),
          "emb.weight": (32, 16)}
SMALL = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=256,
             max_position_embeddings=256, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)


def _opt_case(opt_name, dtype, multi_precision, decay_fun):
    rng = np.random.RandomState(0)
    arrays = {n: (rng.randn(*s) * 0.1).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = [{n: (rng.randn(*s) * 0.01).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(3)]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    jp = [Tensor(jnp.asarray(a, jdt), stop_gradient=False, name=n)
          for n, a in arrays.items()]
    named = [(n, torch.nn.Parameter(torch.tensor(a).to(tdt)))
             for n, a in arrays.items()]
    tp = [p for _, p in named]
    kw = dict(learning_rate=1e-3, multi_precision=multi_precision)
    if opt_name == "AdamW":
        kw["apply_decay_param_fun"] = decay_fun
        jopt = paddle.optimizer.AdamW(parameters=jp, **kw)
        topt = AdamW(parameters=named, **kw)
    else:
        jopt = paddle.optimizer.Adam(parameters=jp, weight_decay=0.01, **kw)
        topt = Adam(parameters=named, weight_decay=0.01, **kw)
    for g in grads:
        for p, (n, arr) in zip(jp, g.items()):
            p.grad = Tensor(jnp.asarray(arr, jdt))
        for p, (n, arr) in zip(tp, g.items()):
            p.grad = torch.tensor(arr).to(tdt)
        jopt.step()
        topt.step()
        topt.clear_grad()
    return jp, tp, jopt, topt


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x._value if isinstance(x, Tensor) else x, np.float32)


@pytest.mark.parametrize("opt_name,dtype,multi_precision,decay", [
    ("AdamW", "float32", False, None),
    ("AdamW", "float32", False, "no_bias"),
    ("AdamW", "bfloat16", True, None),
    ("Adam", "float32", False, None),
])
def test_optimizer_steps_match_jax(opt_name, dtype, multi_precision, decay):
    decay_fun = (lambda name: "bias" not in name) if decay else None
    jp, tp, jopt, topt = _opt_case(opt_name, dtype, multi_precision,
                                   decay_fun)
    for j, t in zip(jp, tp):
        jst, tst = jopt._state_for(j), topt._state_for(t)
        assert set(tst) == set(jst), j.name
        for key in tst:
            np.testing.assert_allclose(_f32(tst[key]), _f32(jst[key]),
                                       rtol=OPT_RTOL, atol=OPT_ATOL,
                                       err_msg=f"{j.name} {key}")
        if dtype == "float32":
            np.testing.assert_allclose(_f32(t), _f32(j), rtol=OPT_RTOL,
                                       atol=OPT_ATOL, err_msg=j.name)
        else:
            assert t.dtype == torch.bfloat16
            step = np.abs(_f32(j)) * 2.0 ** -8 + 1e-30
            assert np.all(np.abs(_f32(t) - _f32(j)) <= step), j.name
    assert topt._global_step == 3


def test_unported_optimizer_options_raise():
    """Every option this test once refused is ported now (clips, the
    low-memory tiers, schedulers); what still raises is ``set_lr`` over
    a scheduler, as in the JAX package."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer.lr import StepDecay

    p = [torch.nn.Parameter(torch.zeros(2))]
    for kw in (dict(grad_clip=ClipGradByGlobalNorm(1.0)),
               dict(moment_dtype="bfloat16"), dict(factored_moment2=True),
               dict(update_rms_clip=1.0)):
        AdamW(parameters=p, **kw)
    opt = AdamW(learning_rate=StepDecay(0.1, 2), parameters=p)
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError):
        opt.set_lr(0.5)


def _models(seed=5, **extra):
    cfg = jgpt.GPTConfig(**SMALL, **extra)
    paddle.seed(seed)
    jm = jgpt.GPTForCausalLM(cfg)
    arrays = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL, **extra), device="cpu")
    return jm, tgpt.gpt_params_from_jax(arrays, tm)


def _ids(K, calls, seed):
    shape = (calls, K, 2, 256) if K > 1 else (calls, 2, 256)
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def _run(jm, tm, K, calls, amp=False):
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    topt = AdamW(learning_rate=LR, parameters=tm.parameters())
    if amp:
        jm, jopt = paddle.amp.decorate(jm, jopt, level="O2",
                                       dtype="bfloat16")
        tm, topt = decorate(tm, topt, level="O2", dtype="bfloat16")
    jstep = JTrainStep(jm, lambda n, x, y: n.loss(x, y), jopt,
                       steps_per_call=K)
    tstep = TrainStep(tm, lambda n, x, y: n.loss(x, y), topt,
                      steps_per_call=K)
    jl, tl = [], []
    for ids in _ids(K, calls, seed=K):
        jl.append(np.asarray(jstep(Tensor(jnp.asarray(ids)),
                                   Tensor(jnp.asarray(ids)))._value))
        t = torch.tensor(ids).long()
        tl.append(tstep(t, t).float().numpy())
    return jopt, topt, np.array(jl, np.float32), np.array(tl)


@pytest.mark.parametrize("K", [1, 2])
def test_train_step_matches_jax(K):
    jm, tm = _models(loss_chunks=4)
    _, topt, jl, tl = _run(jm, tm, K, calls=3)
    assert tl.shape == jl.shape == ((3,) if K == 1 else (3, K))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl.reshape(-1)[-1] < tl.reshape(-1)[0]
    assert topt._global_step == 3 * K
    jp = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_train_step_amp_o2_matches_jax():
    jm, tm = _models(seed=6, loss_chunks=4)
    jopt, topt, jl, tl = _run(jm, tm, 1, calls=2, amp=True)
    np.testing.assert_allclose(tl, jl, rtol=BF16_LOSS_RTOL)
    named = dict(jm.named_parameters())
    atol = PARAM_ATOL * 2                   # two steps
    for name, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16, name
        jmaster = _f32(jopt._state_for(named[name])["master_weight"])
        tmaster = _f32(topt._state_for(p)["master_weight"])
        np.testing.assert_allclose(tmaster, jmaster, rtol=0, atol=atol,
                                   err_msg=name)
        jv = _f32(named[name])
        two_steps = np.abs(jv) * 2.0 ** -7 + atol
        assert np.all(np.abs(_f32(p) - jv) <= two_steps), name


def test_train_step_takes_k_inputs_and_refuses_scaler():
    """A scaler is ported now (``TrainStep`` takes a ``GradScaler``);
    sharded steps and ``steps_per_call < 1`` are still refused."""
    from paddle_tpu_torch.amp import GradScaler

    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL), device="cpu")
    opt = AdamW(parameters=tm.parameters())
    TrainStep(tm, lambda n, x, y: n.loss(x, y), opt, scaler=GradScaler())
    with pytest.raises(NotImplementedError):
        TrainStep(tm, lambda n, x, y: n.loss(x, y), opt, in_shardings=[])
    with pytest.raises(ValueError):
        TrainStep(tm, lambda n, x, y: n.loss(x, y), opt, steps_per_call=0)
