"""Training, the rest: the port against the JAX package on the CPU.

- ``TrainStep`` on a tiny GPT with dropout 0.1 / 0.1 (K = 1 and 2), an
  LR schedule and global-norm clipping: losses at rtol 1e-5, parameters
  within 1e-5 (2 lr at lr 5e-6: Adam moves each parameter about lr a
  step, so a near-zero gradient whose last bits differ may move it lr the
  other way), the threefry generator's state equal after the calls.
- ``use_recompute`` with dropout: the recompute replays the forward's
  keys (gradients bit-equal to no recompute, the generator where the
  forward left it) and the loss equals the JAX model's without
  recompute (1e-5): the JAX package's ``recompute`` cannot draw dropout
  keys in a model of two blocks, eager or in its ``TrainStep`` (the
  first block's ``jax.checkpoint`` leaves its key tracer on the trace
  key stack: ``UnexpectedTracerError``).
- Each remat policy's gradients equal to no remat, bit for bit.
- The 15 schedulers over 50 steps (the rates equal: the same Python
  float arithmetic) and a ``state_dict`` round trip.
- The three clips and ``clip_grad_norm_`` at 1e-6 (float32 sums of
  squares in another order).
- Each Adam low-memory tier over 5 steps at the float32 tolerance of
  ``test_torch_train.py`` (rtol 1e-6, atol 1e-7; bf16 moments within one
  bf16 step).
- The ``GradScaler`` state machine on a planted finite / inf sequence:
  the same scale, counters and skipped steps; a skipped step leaves the
  parameters bit-unchanged.
- O1 ``auto_cast``: each op boundary's output dtype as the JAX
  dispatcher casts it, the fused stack uncast, the loss at bf16's 2e-2.
- float16 O2 with a ``GradScaler`` (eager and ``TrainStep``): losses at
  float16's 2e-2 and the same scale sequence.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpaddle  # noqa: E402
from paddle_tpu.amp import GradScaler as JGradScaler  # noqa: E402
from paddle_tpu.core import random as jrng  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.kernels import fused_transformer as jft  # noqa: E402
from paddle_tpu.nn import clip as jclip  # noqa: E402
from paddle_tpu.optimizer import lr as jlr  # noqa: E402
from paddle_tpu.text import gpt as jgpt  # noqa: E402
import paddle_tpu_torch.amp as tamp  # noqa: E402
from paddle_tpu_torch.core import random as trng  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.kernels import fused_transformer as tft  # noqa: E402
from paddle_tpu_torch.nn import clip as tclip  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW, Adam  # noqa: E402
from paddle_tpu_torch.optimizer import lr as tlr  # noqa: E402
from paddle_tpu_torch.text import gpt as tgpt  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

LR = 5e-6
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
CLIP_TOL = 1e-6
LOW_TOL = 2e-2            # bf16 / float16 losses (a step of 2^-8 / 2^-11)
TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=64)


def _seed(n):
    jrng.seed(n)
    trng.default_generator.manual_seed(n)


def _state_words():
    return (trng.default_generator.get_state().tolist(),
            [int(w) for w in np.asarray(jrng.get_rng_state()).astype(
                np.int64)])


def _models(seed=5, **extra):
    cfg = {**TINY, **extra}
    jpaddle.seed(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg))
    arrays = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device="cpu")
    return jm, tgpt.gpt_params_from_jax(arrays, tm)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x._value if isinstance(x, Tensor) else x, np.float32)


def _sched(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(LR, T_max=10),
                            warmup_steps=2, start_lr=0.0, end_lr=LR)


# ------------------------------------------------------ TrainStep + dropout


@pytest.mark.parametrize("K", [1, 2])
def test_train_step_with_dropout_matches_jax(K):
    jm, tm = _models()
    js, ts = _sched(jlr), _sched(tlr)
    jopt = jpaddle.optimizer.AdamW(
        learning_rate=js, parameters=jm.parameters(),
        grad_clip=jclip.ClipGradByGlobalNorm(1.0))
    topt = AdamW(learning_rate=ts, parameters=tm.parameters(),
                 grad_clip=tclip.ClipGradByGlobalNorm(1.0))
    jstep = JTrainStep(jm, lambda n, x, y: n.loss(x, y), jopt,
                       steps_per_call=K)
    tstep = TrainStep(tm, lambda n, x, y: n.loss(x, y), topt,
                      steps_per_call=K)
    shape = (3, K, 2, 32) if K > 1 else (3, 2, 32)
    ids = np.random.RandomState(K).randint(0, 128, shape).astype(np.int32)
    _seed(11)
    jl, tl = [], []
    for x in ids:
        jl.append(np.asarray(jstep(Tensor(jnp.asarray(x)),
                                   Tensor(jnp.asarray(x)))._value))
        t = torch.tensor(x).long()
        tl.append(tstep(t, t).numpy())
        js.step()
        ts.step()
    np.testing.assert_allclose(np.array(tl), np.array(jl, np.float32),
                               rtol=LOSS_RTOL)
    got, want = _state_words()
    assert got == want
    assert topt._global_step == jopt._global_step == 3 * K
    jp = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_f32(p), jp[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_train_step_reads_the_rate_once_per_call():
    """The K steps of a call share the rate read at the call's start."""
    p = torch.nn.Parameter(torch.zeros(3))
    sched = tlr.LambdaDecay(1.0, lambda e: 1.0 / (1 + e))
    seen = []
    topt = AdamW(learning_rate=sched, parameters=[p], weight_decay=0.0)
    real = topt._apply
    topt._apply = lambda pg, lr: (seen.append(lr), real(pg, lr))
    step = TrainStep(torch.nn.Module(), lambda n, x: (p * x).sum(), topt,
                     steps_per_call=3)
    step(torch.ones(3, 3))
    sched.step()
    step(torch.ones(3, 3))
    assert seen == [1.0] * 3 + [0.5] * 3


def test_recompute_with_dropout_replays_its_keys():
    _, tm = _models(use_recompute=True, fused_stack=False)
    jm, plain = _models(use_recompute=False, fused_stack=False)
    ids = torch.tensor(np.random.RandomState(1).randint(0, 128, (2, 32)))
    _seed(7)
    loss = tm.loss(ids, ids)
    after_forward = trng.default_generator.get_state()
    loss.backward()
    assert torch.equal(trng.default_generator.get_state(), after_forward)
    _seed(7)
    ploss = plain.loss(ids, ids)
    ploss.backward()
    assert torch.equal(loss, ploss)
    pp = dict(plain.named_parameters())
    for name, p in tm.named_parameters():
        assert torch.equal(p.grad, pp[name].grad), name
    _seed(7)
    jl = jm.loss(Tensor(jnp.asarray(ids.numpy().astype(np.int32))),
                 Tensor(jnp.asarray(ids.numpy().astype(np.int32))))
    np.testing.assert_allclose(loss.item(), float(jl._value),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("remat", [True, "dots", "names:qkv,mlp1",
                                   "dots+names:attn",
                                   "names:qkv,attn,proj,mlp1,mlp2"])
def test_remat_policy_gradients_equal_no_remat(remat):
    rng = np.random.RandomState(3)
    L, H, nh = 2, 32, 2
    shapes = [(H,), (H,), (H, 3 * H), (3 * H,), (H, H), (H,), (H,), (H,),
              (H, 4 * H), (4 * H,), (4 * H, H), (H,)]
    flat = [torch.tensor((rng.randn(*s) * 0.1 + (1.0 if i in (0, 6) else 0))
                         .astype(np.float32)) for _ in range(L)
            for i, s in enumerate(shapes)]
    x = torch.tensor(rng.randn(2, 16, H).astype(np.float32))
    grads = {}
    for policy in (False, remat):
        ps = [p.clone().requires_grad_(True) for p in flat]
        xs = x.clone().requires_grad_(True)
        out = tft.fused_block_stack_flat(xs, *ps, num_layers=L, num_heads=nh,
                                         remat=policy)
        (out ** 2).sum().backward()
        grads[policy] = [xs.grad] + [p.grad for p in ps]
    for a, b in zip(grads[False], grads[remat]):
        assert torch.equal(a, b)
    # the JAX policy of the same name gives the same gradients (1e-5)
    jflat = [jnp.asarray(p.numpy()) for p in flat]
    import jax

    jg = jax.grad(lambda x, *p: jnp.sum(jft.fused_block_stack_flat(
        x, *p, num_layers=L, num_heads=nh, remat=remat) ** 2),
        argnums=tuple(range(1 + len(jflat))))(jnp.asarray(x.numpy()), *jflat)
    for a, b in zip(grads[remat], jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_remat_refuses_unknown_names():
    with pytest.raises(ValueError):
        tft._block_body(2, True, 1e-5, "names:qkv,nope")


# ---------------------------------------------------------------- schedulers


def _schedulers(m):
    return {
        "NoamDecay": m.NoamDecay(64, 10, learning_rate=2.0),
        "PiecewiseDecay": m.PiecewiseDecay([5, 20], [0.1, 0.05, 0.01]),
        "NaturalExpDecay": m.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": m.InverseTimeDecay(0.5, 0.2),
        "PolynomialDecay": m.PolynomialDecay(0.5, 20, power=2.0),
        "PolynomialDecayCycle": m.PolynomialDecay(0.5, 12, cycle=True),
        "LinearWarmup": m.LinearWarmup(0.3, 10, 0.0, 0.3),
        "LinearWarmupSched": m.LinearWarmup(m.StepDecay(0.3, 7), 5, 0.01,
                                            0.3),
        "ExponentialDecay": m.ExponentialDecay(0.5, 0.95),
        "MultiStepDecay": m.MultiStepDecay(0.5, [10, 30]),
        "StepDecay": m.StepDecay(0.5, 8, gamma=0.5),
        "LambdaDecay": m.LambdaDecay(0.5, lambda e: 0.9 ** e),
        "MultiplicativeDecay": m.MultiplicativeDecay(0.5, lambda e: 0.97),
        "ReduceOnPlateau": m.ReduceOnPlateau(0.5, patience=2, cooldown=1),
        "CosineAnnealingDecay": m.CosineAnnealingDecay(0.5, 25, 0.01),
        "OneCycleLR": m.OneCycleLR(0.5, 50),
        "OneCycleLRLinear": m.OneCycleLR(0.5, 40, anneal_strategy="linear"),
        "CyclicLR": m.CyclicLR(0.1, 0.5, 6),
        "CyclicLR2": m.CyclicLR(0.1, 0.5, 4, mode="triangular2"),
        "CyclicLRExp": m.CyclicLR(0.1, 0.5, 5, mode="exp_range",
                                  exp_gamma=0.98),
    }


@pytest.mark.parametrize("name", list(_schedulers(tlr)))
def test_scheduler_matches_jax_over_50_steps(name):
    js, ts = _schedulers(jlr)[name], _schedulers(tlr)[name]
    metrics = [1.0 / (1 + (i % 7)) for i in range(50)]
    for i in range(50):
        assert ts() == js() and ts.get_lr() == js.get_lr(), i
        if name == "ReduceOnPlateau":
            js.step(metrics[i])
            ts.step(metrics[i])
        else:
            js.step()
            ts.step()
    sd = ts.state_dict()
    assert sd == js.state_dict()
    fresh = _schedulers(tlr)[name]
    fresh.set_state_dict(sd)
    assert fresh() == ts() and fresh.last_epoch == ts.last_epoch


def test_scheduler_drives_the_optimizer():
    p = [torch.nn.Parameter(torch.zeros(2))]
    sched = tlr.StepDecay(0.5, 2, gamma=0.5)
    opt = Adam(learning_rate=sched, parameters=p)
    rates = []
    for _ in range(5):
        rates.append(opt.get_lr())
        sched.step()
    assert rates == [0.5, 0.5, 0.25, 0.25, 0.125]
    opt.set_lr_scheduler(tlr.ExponentialDecay(1.0, 0.5))
    assert opt.get_lr() == 1.0


# --------------------------------------------------------------------- clips


def _grads(dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * sc).astype(dtype) for s, sc in
            (((4, 6), 1.0), ((6,), 3.0), ((3, 3, 2), 0.5))]


@pytest.mark.parametrize("clip,args", [("ClipGradByValue", (0.8,)),
                                       ("ClipGradByValue", (0.8, -0.3)),
                                       ("ClipGradByNorm", (1.5,)),
                                       ("ClipGradByGlobalNorm", (2.0,)),
                                       ("ClipGradByGlobalNorm", (100.0,))])
def test_clips_match_jax(clip, args):
    gs = _grads()
    jpg = [(None, Tensor(jnp.asarray(g))) for g in gs] + [(None, None)]
    tpg = [(None, torch.tensor(g)) for g in gs] + [(None, None)]
    jout = getattr(jclip, clip)(*args)(jpg)
    tout = getattr(tclip, clip)(*args)(tpg)
    assert tout[-1][1] is None
    for (_, jg), (_, tg) in zip(jout[:-1], tout[:-1]):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg._value),
                                   rtol=CLIP_TOL, atol=CLIP_TOL)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, math.inf])
def test_clip_grad_norm_matches_jax(norm_type):
    gs = _grads(seed=2)
    jps, tps = [], []
    for g in gs:
        jp = Tensor(jnp.zeros(g.shape), stop_gradient=False)
        jp.grad = Tensor(jnp.asarray(g))
        tp = torch.nn.Parameter(torch.zeros(g.shape))
        tp.grad = torch.tensor(g)
        jps.append(jp)
        tps.append(tp)
    jt = jclip.clip_grad_norm_(jps, 1.0, norm_type)
    tt = tclip.clip_grad_norm_(tps, 1.0, norm_type)
    np.testing.assert_allclose(tt.item(), float(jt._value), rtol=CLIP_TOL)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad._value),
                                   rtol=CLIP_TOL, atol=CLIP_TOL)


def test_optimizer_step_applies_the_clip():
    """The eager ``step`` clips before its update, as the JAX one."""
    gs = _grads(seed=4)
    jps = [Tensor(jnp.asarray(g * 0), stop_gradient=False) for g in gs]
    tps = [torch.nn.Parameter(torch.tensor(g * 0)) for g in gs]
    jopt = jpaddle.optimizer.Adam(0.1, parameters=jps,
                                  grad_clip=jclip.ClipGradByGlobalNorm(0.5))
    topt = Adam(0.1, parameters=tps,
                grad_clip=tclip.ClipGradByGlobalNorm(0.5))
    for jp, tp, g in zip(jps, tps, gs):
        jp.grad = Tensor(jnp.asarray(g))
        tp.grad = torch.tensor(g)
    jopt.step()
    topt.step()
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._value),
                                   rtol=OPT_RTOL, atol=OPT_ATOL)


# ------------------------------------------------------------ Adam's tiers


TIERS = {
    "bf16_moments": dict(moment_dtype="bfloat16"),
    "beta1_0": dict(beta1=0.0),
    "factored": dict(factored_moment2=True),
    "rms_clip": dict(update_rms_clip=0.5),
    "all_lowmem": dict(moment_dtype="bfloat16", factored_moment2=True,
                       beta1=0.0, update_rms_clip=1.0),
    "master_bf16_moments": dict(moment_dtype="bfloat16",
                                multi_precision=True),
}


@pytest.mark.parametrize("tier", list(TIERS))
def test_adam_tier_matches_jax(tier):
    kw = dict(TIERS[tier])
    master = kw.get("multi_precision", False)
    rng = np.random.RandomState(1)
    shapes = {"w": (8, 12), "b": (12,), "t": (3, 4, 5)}
    arrays = {n: (rng.randn(*s) * 0.1).astype(np.float32)
              for n, s in shapes.items()}
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if master else (jnp.float32,
                                                              torch.float32)
    jp = [Tensor(jnp.asarray(a).astype(jdt), stop_gradient=False, name=n)
          for n, a in arrays.items()]
    tp = [torch.nn.Parameter(torch.tensor(a).to(tdt)) for a in
          arrays.values()]
    jopt = jpaddle.optimizer.AdamW(learning_rate=1e-3, parameters=jp, **kw)
    topt = AdamW(learning_rate=1e-3, parameters=tp, **kw)
    for step in range(5):
        for j, t, s in zip(jp, tp, shapes.values()):
            g = (rng.randn(*s) * (0.01 if step != 2 else 1.0)).astype(
                np.float32)
            j.grad = Tensor(jnp.asarray(g).astype(jdt))
            t.grad = torch.tensor(g).to(tdt)
        jopt.step()
        topt.step()
    for j, t in zip(jp, tp):
        if master:
            jm = np.asarray(jopt._state_for(j)["master_weight"]._value)
            tm = topt._state_for(t)["master_weight"].numpy()
            np.testing.assert_allclose(tm, jm, rtol=OPT_RTOL, atol=OPT_ATOL)
        else:
            np.testing.assert_allclose(_f32(t), _f32(j), rtol=OPT_RTOL,
                                       atol=OPT_ATOL)
        jst = jopt._state_for(j)
        tst = topt._state_for(t)
        assert set(jst) == set(tst)
        for k in jst:
            a, b = _f32(tst[k]), _f32(jst[k])
            assert tst[k].dtype == {jnp.float32: torch.float32,
                                    jnp.bfloat16: torch.bfloat16}[
                jst[k]._value.dtype.type], k
            step_ = np.abs(b) * 2.0 ** -7 + 1e-30 if tst[k].dtype == \
                torch.bfloat16 else np.abs(b) * OPT_RTOL + OPT_ATOL
            assert np.all(np.abs(a - b) <= step_), k


def test_adam_state_bytes_of_the_low_memory_tier():
    """bf16 moments, no first moment and factored second moments: the
    state of a [R, C] parameter is R + C float32 values and two float32
    scalars (what ``chip_smoke.py``'s ``phase_adam_lowmem`` counts)."""
    p = torch.nn.Parameter(torch.zeros(64, 32))
    b = torch.nn.Parameter(torch.zeros(32))
    opt = AdamW(parameters=[p, b], moment_dtype="bfloat16", beta1=0.0,
                factored_moment2=True, update_rms_clip=1.0)
    p.grad, b.grad = torch.ones_like(p), torch.ones_like(b)
    opt.step()
    nbytes = sum(t.numel() * t.element_size()
                 for x in (p, b) for t in opt._state_for(x).values())
    assert nbytes == (64 + 32) * 4 + 8 + 32 * 2 + 8


# ------------------------------------------------------------------ scaler


def test_grad_scaler_state_machine_matches_jax():
    """A planted sequence of finite and non-finite gradients: the scale,
    the good / bad counters and the skipped steps follow the JAX
    scaler's, and a skipped step leaves the parameters bit-unchanged."""
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    js, ts = JGradScaler(**kw), tamp.GradScaler(**kw)
    jp = Tensor(jnp.zeros((4,)), stop_gradient=False)
    tp = torch.nn.Parameter(torch.zeros(4))
    jopt = jpaddle.optimizer.Adam(0.1, parameters=[jp])
    topt = Adam(0.1, parameters=[tp])
    plan = [1.0, 1.0, 1.0, math.inf, math.nan, math.inf, 1.0, 1.0, 1.0]
    for i, bad in enumerate(plan):
        g = np.array([0.5, -1.0, 2.0, bad], np.float32) * 1024.0
        jp.grad = Tensor(jnp.asarray(g))
        tp.grad = torch.tensor(g)
        before = tp.detach().clone()
        js.step(jopt)
        ts.step(topt)
        if not math.isfinite(bad):
            assert torch.equal(tp.detach(), before), i
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._value),
                                   rtol=OPT_RTOL, atol=OPT_ATOL)
        assert ts.state_dict() == js.state_dict(), i
        assert ts._found_inf is False
    # unscale_ is done once a step: a second call is a no-op
    tp.grad = torch.ones(4) * 8.0
    ts.unscale_(topt)
    once = tp.grad.clone()
    ts.unscale_(topt)
    assert torch.equal(tp.grad, once)


# --------------------------------------------------------------------- AMP


def test_o1_dtypes_at_each_op_boundary():
    """Under O1 bf16: white ops (linear, matmul, sdpa) run in bf16,
    black ops (layer_norm, softmax, cross_entropy) in float32, gray ops
    (gelu, dropout, embedding) in their inputs' dtypes; the same under
    the JAX dispatcher."""
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF
    from paddle_tpu.amp import auto_cast as jauto_cast

    x = np.random.RandomState(0).randn(2, 4, 8).astype(np.float32)
    w = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    b = np.zeros(8, np.float32)
    jx, jw, jb = (Tensor(jnp.asarray(a)) for a in (x, w, b))
    tx, tw, tb = (torch.tensor(a) for a in (x, w, b))
    cases = {
        "linear": (lambda: JF.linear(jx, jw, jb),
                   lambda: TF.linear(tx, tw, tb)),
        "layer_norm": (lambda: JF.layer_norm(jx.astype("bfloat16"), 8),
                       lambda: TF.layer_norm(tx.bfloat16(), 8)),
        "softmax": (lambda: JF.softmax(jx.astype("bfloat16")),
                    lambda: TF.softmax(tx.bfloat16())),
        "gelu": (lambda: JF.gelu(jx), lambda: TF.gelu(tx)),
        "sdpa": (lambda: JF.scaled_dot_product_attention(
                     jx.reshape([2, 4, 1, 8]), jx.reshape([2, 4, 1, 8]),
                     jx.reshape([2, 4, 1, 8])),
                 lambda: TF.scaled_dot_product_attention(
                     tx.reshape(2, 4, 1, 8), tx.reshape(2, 4, 1, 8),
                     tx.reshape(2, 4, 1, 8))),
    }
    names = {jnp.dtype("float32"): torch.float32,
             jnp.dtype(jnp.bfloat16): torch.bfloat16}
    for level in ("O1", "O2"):
        for name, (jf, tf) in cases.items():
            with jauto_cast(level=level):
                jd = names[jnp.dtype(jf()._value.dtype)]
            with tamp.auto_cast(level=level):
                td = tf().dtype
            assert td == jd, (level, name)
            assert tamp.amp_op_dtype(name) is None          # outside
    with tamp.auto_cast(level="O1", custom_black_list={"linear"}):
        assert TF.linear(tx, tw, tb).dtype == torch.float32
    with tamp.auto_cast(enable=False):
        assert TF.linear(tx, tw, tb).dtype == torch.float32


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_o1_gpt_loss_matches_jax(dropout):
    """A tiny GPT under O1 bf16: with dropout in training it runs
    unfused (bf16 linears, float32 LayerNorm and loss), without it the
    fused stack is one gray op and runs in float32; the loss within
    bf16's 2e-2 of the JAX model's and its gradients' dtypes float32."""
    from paddle_tpu.amp import auto_cast as jauto_cast

    jm, tm = _models(hidden_dropout_prob=dropout,
                     attention_probs_dropout_prob=dropout)
    ids = np.random.RandomState(2).randint(0, 128, (2, 32)).astype(np.int32)
    _seed(3)
    with jauto_cast(level="O1"):
        jl = jm.loss(Tensor(jnp.asarray(ids)), Tensor(jnp.asarray(ids)))
    with tamp.auto_cast(level="O1"):
        t = torch.tensor(ids).long()
        tl = tm.loss(t, t)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), float(jl._value), rtol=LOW_TOL)
    if dropout == 0.0:
        # the fused stack is float32 inside under O1: float32 accuracy
        np.testing.assert_allclose(tl.item(), float(jl._value), rtol=1e-4)
    tl.backward()
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())


def test_fp16_o2_with_scaler_matches_jax():
    """float16 O2 (every parameter float16, float32 masters) with an
    initial scale high enough that the first steps overflow: eager
    ``scaler.scale(loss).backward(); scaler.step(opt)`` on both sides,
    the same skipped steps and scale sequence, the losses at float16's
    2e-2; then ``TrainStep`` with the scaler (scale and unscale, no
    check) against the JAX ``TrainStep``."""
    jm, tm = _models(seed=9, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    jopt = jpaddle.optimizer.AdamW(1e-3, parameters=jm.parameters())
    topt = AdamW(1e-3, parameters=tm.parameters())
    jm, jopt = jpaddle.amp.decorate(jm, jopt, level="O2", dtype="float16")
    tm, topt = tamp.decorate(tm, topt, level="O2", dtype="float16")
    kw = dict(init_loss_scaling=2.0 ** 40, decr_every_n_nan_or_inf=1,
              incr_every_n_steps=3)
    js, ts = JGradScaler(**kw), tamp.GradScaler(**kw)
    ids = np.random.RandomState(4).randint(0, 128, (6, 2, 32)).astype(
        np.int32)
    scales, skipped = [], 0
    for x in ids:
        jl = jm.loss(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(x)))
        js.scale(jl).backward()
        js.step(jopt)
        jopt.clear_grad()
        t = torch.tensor(x).long()
        tl = tm.loss(t, t)
        before = [p.detach().clone() for p in tm.parameters()]
        ts.scale(tl).backward()
        ts.unscale_(topt)
        found = ts._found_inf
        ts.step(topt)
        topt.clear_grad()
        if found:
            skipped += 1
            assert all(torch.equal(a, p.detach()) for a, p in
                       zip(before, tm.parameters()))
        scales.append((ts._scale, js._scale))
        np.testing.assert_allclose(tl.float().item(), float(
            jl._value.astype(jnp.float32)), rtol=LOW_TOL)
    assert skipped >= 2
    assert all(a == b for a, b in scales), scales
    jstep = JTrainStep(jm, lambda n, x, y: n.loss(x, y), jopt, scaler=js)
    tstep = TrainStep(tm, lambda n, x, y: n.loss(x, y), topt, scaler=ts)
    x = ids[0]
    jl = jstep(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(x)))
    t = torch.tensor(x).long()
    tl = tstep(t, t)
    np.testing.assert_allclose(tl.float().item(),
                               float(jl._value.astype(jnp.float32)),
                               rtol=LOW_TOL)
    assert ts._scale == js._scale
