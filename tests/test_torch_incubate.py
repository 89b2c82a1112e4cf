"""The port's ``incubate`` (but ``nn`` and ``optimizer``, held in
``test_torch_bert_fused.py`` and ``test_torch_optimizers_tail.py``) and
``text.datasets`` against the JAX package's, on the CPU.

- ASP: ``get_mask_1d`` / ``get_mask_2d_greedy`` bit-equal to the JAX
  masks on random values and on values full of ties (``argsort``'s
  order), given arrays (arrays back) and tensors (tensors of their dtype
  on their device back); the checks; ``prune_model`` over Linear and
  Conv2D weights (with an excluded layer) equal to the JAX package's,
  and two steps of a ``decorate``d optimizer equal to the JAX ones with
  the pruned weights held at 0.
- ``incubate.autograd``: ``jvp``, ``vjp``, ``Jacobian`` (one and two
  inputs: the unflattened output-then-input shape) and ``Hessian`` of a
  small tanh MLP, and ``jvp`` through attention at a flash shape,
  shapes and values at rtol = atol = 1e-5;
  ``forward_grad`` raises the JAX message; the prim switches.
- ``train_epoch_range``: a loop killed after its second epoch restores
  the model and optimizer and resumes at the third, as the JAX one.
- ``reduce_tensor``: float32 and bfloat16 through ``ForkingPickler``
  (a handle, not the data) and into another interpreter.
- ``viterbi_decode``: scores at 1e-5 and paths exact against the JAX
  ``lax.scan`` form, with ties (integer potentials) and short lengths,
  with and without the BOS / EOS tags.
- Each dataset on a small local file written here, sample for sample
  equal to the JAX package's, and the JAX message without a file.
- ``softmax_mask_fuse`` / ``_upper_triangle``, ``identity_loss``,
  ``graph_send_recv``, ``graph_khop_sampler`` (its properties; edge ids
  raise), ``incubate.distributed`` raising with ROADMAP A.12.
"""
import gzip
import io
import json
import pickle
import tarfile
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpaddle  # noqa: E402
import paddle_tpu.incubate as jinc  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.text.datasets as jds  # noqa: E402
from paddle_tpu.incubate import asp as jasp  # noqa: E402
from paddle_tpu.incubate import autograd as jag  # noqa: E402
import paddle_tpu_torch as tpaddle  # noqa: E402
import paddle_tpu_torch.incubate as tinc  # noqa: E402
import paddle_tpu_torch.nn as tnn  # noqa: E402
import paddle_tpu_torch.text.datasets as tds  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.incubate import asp as tasp  # noqa: E402
from paddle_tpu_torch.incubate import autograd as tag  # noqa: E402
from paddle_tpu_torch.incubate.multiprocessing import reductions  # noqa: E402
from paddle_tpu_torch.nn import layer_state_from_jax  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    tpaddle.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(t):
    return np.asarray(t.numpy())


# ------------------------------------------------------------------ ASP ---

@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("algo", ["get_mask_1d", "get_mask_2d_greedy"])
def test_masks_bit_equal_to_jax(algo, ties):
    rng = np.random.default_rng(0)
    mat = (rng.integers(-2, 3, (12, 10)) if ties
           else rng.standard_normal((12, 10))).astype(np.float32)
    want = getattr(jasp, algo)(mat)
    got = getattr(tasp, algo)(mat)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    as_tensor = getattr(tasp, algo)(torch.tensor(mat).to(torch.bfloat16))
    assert as_tensor.dtype == torch.bfloat16 and as_tensor.device.type == "cpu"
    np.testing.assert_array_equal(as_tensor.float().numpy(), want)
    check = "check_mask_1d" if algo == "get_mask_1d" else "check_mask_2d"
    assert getattr(tasp, check)(mat * got) and getattr(jasp, check)(mat * got)
    assert not getattr(tasp, check)(np.ones((12, 10), np.float32))
    assert tasp.calculate_density(mat * got) == jasp.calculate_density(
        mat * got)


def _asp_models():
    jpaddle.seed(3)
    jm = jnn.Sequential(jnn.Linear(16, 12), jnn.ReLU(), jnn.Linear(12, 8),
                        jnn.ReLU(), jnn.Linear(8, 4))
    tm = tnn.Sequential(tnn.Linear(16, 12), tnn.ReLU(), tnn.Linear(12, 8),
                        tnn.ReLU(), tnn.Linear(8, 4))
    layer_state_from_jax({n: _np(p) for n, p in jm.named_parameters()}, tm)
    return jm, tm


@pytest.mark.parametrize("mask_algo", ["mask_1d", "mask_2d_greedy"])
def test_prune_model_and_decorated_steps_match_jax(mask_algo):
    jm, tm = _asp_models()
    try:
        jasp.set_excluded_layers(jm, ["4"])
        tasp.set_excluded_layers(tm, ["4"])
        jmasks = jasp.prune_model(jm, mask_algo=mask_algo)
        tmasks = tasp.prune_model(tm, mask_algo=mask_algo)
    finally:
        jasp.reset_excluded_layers()
        tasp.reset_excluded_layers()
    assert len(tmasks) == len(jmasks) == 2
    for a, b in zip(tmasks.values(), jmasks.values()):
        np.testing.assert_array_equal(a, b)
    jopt = jasp.decorate(jpaddle.optimizer.AdamW(
        0.01, parameters=jm.parameters()))
    topt = tasp.decorate(tpaddle.optimizer.AdamW(
        0.01, parameters=tm.parameters()))
    x = np.random.default_rng(1).standard_normal((6, 16)).astype(np.float32)
    for _ in range(2):
        jm(jpaddle.to_tensor(x)).square().mean().backward()
        jopt.step()
        jopt.clear_grad()
        tm(torch.tensor(x)).square().mean().backward()
        topt.step()
        topt.clear_grad()
    for (n, jp), tp in zip(jm.named_parameters(), tm.parameters()):
        np.testing.assert_allclose(tp.detach().numpy(), _np(jp), **TOL,
                                   err_msg=n)
    for w, mask in zip((tm[0].weight, tm[2].weight), tmasks.values()):
        assert torch.all(w[torch.tensor(mask) == 0] == 0)
        assert tasp.check_mask_1d(w.detach().numpy().T)


def test_prune_conv_weight_matches_jax():
    jpaddle.seed(4)
    jc = jnn.Conv2D(4, 8, 3)
    tc = tnn.Conv2D(4, 8, 3)
    layer_state_from_jax({n: _np(p) for n, p in jc.named_parameters()}, tc)
    jm = list(jasp.prune_model(jc).values())[0]
    tm = list(tasp.prune_model(tc).values())[0]
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tc.weight.detach().numpy(), _np(jc.weight))
    with pytest.raises(ValueError, match="unknown mask_algo"):
        tasp.prune_model(tc, mask_algo="mask_3d")


# ------------------------------------------------------------- autograd ---

W1 = np.random.default_rng(5).standard_normal((3, 4)).astype(np.float32)
W2 = np.random.default_rng(6).standard_normal((4, 2)).astype(np.float32)
X = np.random.default_rng(7).standard_normal((2, 3)).astype(np.float32)


def _mlp(mod, to):
    return lambda x: mod.tanh(mod.matmul(mod.tanh(mod.matmul(x, to(W1))),
                                         to(W2)))


def _both():
    return (_mlp(tpaddle, torch.tensor), _mlp(jpaddle, jpaddle.to_tensor))


def test_jvp_vjp_match_jax():
    tf, jf = _both()
    v = np.random.default_rng(8).standard_normal(X.shape).astype(np.float32)
    for t, j in ((tag.jvp(tf, torch.tensor(X), torch.tensor(v)),
                  jag.jvp(jf, jpaddle.to_tensor(X), jpaddle.to_tensor(v))),
                 (tag.jvp(tf, torch.tensor(X)),
                  jag.jvp(jf, jpaddle.to_tensor(X)))):
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    out_t, g_t = tag.vjp(tf, torch.tensor(X))
    out_j, g_j = jag.vjp(jf, jpaddle.to_tensor(X))
    assert isinstance(g_t, tuple) and len(g_t) == len(g_j) == 1
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), **TOL)
    np.testing.assert_allclose(g_t[0].numpy(), _np(g_j[0]), **TOL)


def test_jacobian_and_hessian_match_jax():
    tf, jf = _both()
    jt, jj = tag.Jacobian(tf, torch.tensor(X)), jag.Jacobian(
        jf, jpaddle.to_tensor(X), is_batched=True)
    assert jt.shape == jj.shape == [2, 2, 2, 3]
    np.testing.assert_allclose(jt.numpy(), jj.numpy(), **TOL)
    np.testing.assert_allclose(jt[0, 1].numpy(), _np(jj[0, 1]), **TOL)
    # two inputs: one Jacobian per input, the first under shape / numpy
    w = np.random.default_rng(9).standard_normal((3, 2)).astype(np.float32)
    t2 = tag.Jacobian(lambda x, w: torch.tanh(x @ w),
                      [torch.tensor(X), torch.tensor(w)])
    j2 = jag.Jacobian(lambda x, w: jpaddle.tanh(jpaddle.matmul(x, w)),
                      [jpaddle.to_tensor(X), jpaddle.to_tensor(w)])
    assert t2.shape == j2.shape == [2, 2, 2, 3]
    for a, b in zip(t2.as_tensors(), j2.as_tensors()):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    ht = tag.Hessian(lambda x: tf(x).sum(), torch.tensor(X))
    hj = jag.Hessian(lambda x: jf(x).sum(), jpaddle.to_tensor(X))
    assert ht.shape == hj.shape == [2, 3, 2, 3]
    np.testing.assert_allclose(ht.numpy(), hj.numpy(), **TOL)
    with pytest.raises(ValueError, match="single input"):
        tag.Hessian(lambda x, w: (x @ w).sum(),
                    [torch.tensor(X), torch.tensor(w)])


def test_jvp_through_flash_eligible_attention_matches_jax():
    """Attention at a flash shape (head size 64, 128 keys): ``jvp``
    differentiates the flash op's backward, which under
    ``create_graph`` is the plain forward's graph (the kernels' backward
    ops have no derivative of their own)."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF

    x = np.random.default_rng(10).standard_normal((1, 128, 2, 64)).astype(
        np.float32)
    t = tag.jvp(lambda q: TF.scaled_dot_product_attention(
        q, q, q, training=False), torch.tensor(x))
    j = jag.jvp(lambda q: JF.scaled_dot_product_attention(
        q, q, q, training=False), jpaddle.to_tensor(x))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)


def _flash_attention_fn(mod):
    """A function of 4 values through self-attention at a flash shape
    ([1, 128, 2, 64]): q = k = v = the values times a fixed [4, 16384]
    projection, summed with fixed weights."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF

    rng = np.random.default_rng(11)
    proj = (rng.standard_normal((4, 128 * 2 * 64)) / 8).astype(np.float32)
    w = rng.standard_normal((1, 128, 2, 64)).astype(np.float32)
    F, to = ((TF, torch.tensor) if mod is tpaddle
             else (JF, jpaddle.to_tensor))

    def fn(x):
        q = mod.reshape(mod.matmul(x, to(proj)), [1, 128, 2, 64])
        return (F.scaled_dot_product_attention(q, q, q, training=False)
                * to(w)).sum()
    return fn


def _spy_flash_backward(monkeypatch):
    """Counts of the flash op's backward: its two kernel ops and the
    differentiable plain recomputation."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    calls = {"dkdv": 0, "dq": 0, "graph": 0}
    for key, name in (("dkdv", "flash_bwd_dkdv_op"), ("dq", "flash_bwd_dq_op"),
                      ("graph", "_differentiable_backward")):
        def spy(*args, _run=getattr(fa, name), _key=key):
            calls[_key] += 1
            return _run(*args)
        monkeypatch.setattr(fa, name, spy)
    return calls


def test_vjp_and_jacobian_run_the_flash_backward_ops(monkeypatch):
    """First-order transforms through flash-eligible attention take the
    flash op's backward ops (the kernels on the card), equal to JAX."""
    calls = _spy_flash_backward(monkeypatch)
    x = np.random.default_rng(12).standard_normal(4).astype(np.float32)
    tf, jf = _flash_attention_fn(tpaddle), _flash_attention_fn(jpaddle)
    out_t, (g_t,) = tag.vjp(tf, torch.tensor(x))
    out_j, (g_j,) = jag.vjp(jf, jpaddle.to_tensor(x))
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), **TOL)
    np.testing.assert_allclose(g_t.numpy(), _np(g_j), **TOL)
    jt = tag.Jacobian(tf, torch.tensor(x))
    np.testing.assert_allclose(jt.numpy(), g_t.numpy(), **TOL)
    assert calls == {"dkdv": 2, "dq": 2, "graph": 0}


def test_hessian_through_flash_eligible_attention_matches_jax(monkeypatch):
    """``Hessian`` differentiates the flash op's backward: the plain
    recomputation, equal to JAX's Hessian of the same function."""
    calls = _spy_flash_backward(monkeypatch)
    x = np.random.default_rng(13).standard_normal(4).astype(np.float32)
    ht = tag.Hessian(_flash_attention_fn(tpaddle), torch.tensor(x))
    hj = jag.Hessian(_flash_attention_fn(jpaddle), jpaddle.to_tensor(x))
    assert ht.shape == hj.shape == [4, 4]
    np.testing.assert_allclose(ht.numpy(), hj.numpy(), **TOL)
    assert calls["graph"] > 0 and calls["dkdv"] == calls["dq"] == 0


def test_forward_grad_raises_and_prim_switches():
    with pytest.raises(RuntimeError) as t_err:
        tag.forward_grad(None, None)
    with pytest.raises(RuntimeError) as j_err:
        jag.forward_grad(None, None)
    assert str(t_err.value) == str(j_err.value)
    tag.enable_prim()
    assert tag.prim_enabled()
    tag.disable_prim()
    assert not tag.prim_enabled()
    x = torch.tensor(X, requires_grad=True)
    (g,) = tag.grad((x * x).sum(), x)
    np.testing.assert_allclose(g.numpy(), 2 * X, **TOL)


# ----------------------------------------------------------- checkpoint ---

def _epochs(pkg, model, opt, kill_after=None):
    seen = []
    for epoch in pkg.incubate.checkpoint.train_epoch_range(
            4, model=model, optimizer=opt, name="job"):
        model(pkg.to_tensor(X)).sum().backward()
        opt.step()
        opt.clear_grad()
        seen.append(epoch)
        if epoch == kill_after:
            break       # killed before this epoch's save
    return seen


def test_train_epoch_range_restores_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_CHECKPOINT_DIR", str(tmp_path))
    tpaddle.seed(0)
    model = tnn.Linear(3, 2)
    opt = tpaddle.optimizer.Adam(0.1, parameters=model.parameters())
    assert _epochs(tpaddle, model, opt, kill_after=2) == [0, 1, 2]
    status = json.loads((tmp_path / "job" / "train_status.json").read_text())
    assert status["epoch_no"] == 1
    saved = tpaddle.load(str(tmp_path / "job" / "model_0.pdparams"))
    fresh = tnn.Linear(3, 2)
    fresh_opt = tpaddle.optimizer.Adam(0.1, parameters=fresh.parameters())
    resumed = tinc.checkpoint.train_epoch_range(4, name="job").attach(
        fresh, fresh_opt)
    assert resumed.status.epoch_no == 1
    seen = []
    for epoch in resumed:
        if not seen:
            for k, v in fresh.state_dict().items():
                assert torch.equal(v, saved[k])
            assert fresh_opt._global_step == 2
        seen.append(epoch)
    assert seen == [2, 3]
    # the JAX loop over the same protocol yields the same epochs
    monkeypatch.setenv("PADDLE_CHECKPOINT_DIR", str(tmp_path / "jax"))
    jm = jnn.Linear(3, 2)
    jo = jpaddle.optimizer.Adam(0.1, parameters=jm.parameters())
    assert _epochs(jpaddle, jm, jo, kill_after=2) == [0, 1, 2]
    assert [e for e in jinc.checkpoint.train_epoch_range(4, name="job")] \
        == seen


# ------------------------------------------------------ multiprocessing ---

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_tensor_round_trips(dtype):
    from multiprocessing.reduction import ForkingPickler

    x = tpaddle.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    x = x.astype(dtype)
    payload = bytes(ForkingPickler.dumps(x))
    assert len(payload) < x.numel() * x.element_size() + 400
    got = pickle.loads(payload)
    assert got.dtype == dtype and isinstance(got, tpaddle.Tensor)
    assert torch.equal(got, x) and got.stop_gradient
    fn, args = reductions.reduce_tensor(x)
    assert args[2] == ("__bf16__" if dtype == torch.bfloat16 else "float32")


_CHILD = """
import pickle, sys
t = pickle.loads(sys.stdin.buffer.read())
print(str(t.dtype), t.float().sum().item())
"""


def test_reduce_tensor_through_a_child_process():
    """The handle opens the same pages in another interpreter."""
    import subprocess
    import sys
    from multiprocessing.reduction import ForkingPickler

    import paddle_tpu_torch.incubate.multiprocessing as tmp_

    x = tpaddle.to_tensor(np.linspace(-1, 1, 64, dtype=np.float32)).astype(
        "bfloat16")
    try:
        out = subprocess.run(
            [sys.executable, "-c", _CHILD],
            input=bytes(ForkingPickler.dumps(x)), capture_output=True,
            timeout=120, check=True).stdout.decode().split()
    finally:
        tmp_.tensor_shm_unlink_all()
    assert out == ["torch.bfloat16", repr(x.float().sum().item())]


# -------------------------------------------------------------- viterbi ---

@pytest.mark.parametrize("bos_eos", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_viterbi_matches_jax(bos_eos, ties):
    rng = np.random.default_rng(11)
    B, T, N = 5, 7, 6
    if ties:
        pot = rng.integers(-1, 2, (B, T, N)).astype(np.float32)
        trans = rng.integers(-1, 2, (N, N)).astype(np.float32)
    else:
        pot = rng.standard_normal((B, T, N)).astype(np.float32)
        trans = rng.standard_normal((N, N)).astype(np.float32)
    lens = np.array([7, 1, 3, 5, 2], np.int64)
    ts, tp = tds.viterbi_decode(torch.tensor(pot), torch.tensor(trans),
                                torch.tensor(lens), bos_eos)
    js, jp = jds.viterbi_decode(jpaddle.to_tensor(pot),
                                jpaddle.to_tensor(trans),
                                jpaddle.to_tensor(lens), bos_eos)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)
    np.testing.assert_array_equal(tp.numpy(), _np(jp))
    dec = tds.ViterbiDecoder(torch.tensor(trans), bos_eos)
    s2, p2 = dec(torch.tensor(pot), torch.tensor(lens))
    assert torch.equal(s2, ts) and torch.equal(p2, tp)


# ------------------------------------------------------------- datasets ---

def _tar(path, members):
    with tarfile.open(path, "w:gz") as tf:
        for name, content in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(content)
            tf.addfile(info, io.BytesIO(content))
    return str(path)


def _files(tmp):
    rng = np.random.default_rng(0)
    f = {}
    np.savetxt(tmp / "housing.data",
               rng.normal(size=(30, 14)).astype("float32"))
    f["UCIHousing"] = [dict(data_file=str(tmp / "housing.data"), mode=m)
                       for m in ("train", "test")]
    f["Imdb"] = [dict(data_file=_tar(tmp / "imdb.tgz", {
        "aclImdb/train/pos/0_9.txt": b"a wonderful, movie<br />" * 30,
        "aclImdb/train/neg/0_1.txt": b"a terrible movie! " * 30,
        "aclImdb/test/pos/0_8.txt": b"wonderful wonderful a " * 30}),
        mode=m, cutoff=10) for m in ("train", "test")]
    z = tmp / "ml-1m.zip"
    with zipfile.ZipFile(z, "w") as zf:
        zf.writestr("ml-1m/movies.dat",
                    "1::Toy Story (1995)::Animation|Comedy\n"
                    "2::Jumanji (1995)::Adventure\n")
        zf.writestr("ml-1m/users.dat",
                    "1::M::25::4::12345\n2::F::35::7::54321\n")
        zf.writestr("ml-1m/ratings.dat", "".join(
            f"{u}::{m}::{r}::9783007{i}\n" for i, (u, m, r) in enumerate(
                [(1, 1, 5), (1, 2, 3), (2, 1, 4), (2, 2, 2), (1, 3, 1)])))
    f["Movielens"] = [dict(data_file=str(z), mode=m, test_ratio=0.4,
                           rand_seed=3) for m in ("train", "test")]
    words = b"The\ncat\nsaw\nit\n\nDogs\nrun\n\n"
    props = (b"-\t(A0*)\n-\t*\nsee\t(V*)\n-\t(A1*)\n\n"
             b"-\t(A0*)\nrun\t(V*)\n\n")
    (tmp / "wordDict.txt").write_text("the\ncat\nsaw\nit\ndogs\n<unk>\n")
    (tmp / "verbDict.txt").write_text("see\nrun\n")
    (tmp / "targetDict.txt").write_text("B-A0\nI-A0\nB-A1\nB-V\nO\n")
    f["Conll05st"] = [dict(data_file=_tar(tmp / "conll.tgz", {
        "c/test.wsj.words.gz": gzip.compress(words),
        "c/test.wsj.props.gz": gzip.compress(props)}),
        word_dict_file=str(tmp / "wordDict.txt"),
        verb_dict_file=str(tmp / "verbDict.txt"),
        target_dict_file=str(tmp / "targetDict.txt"))]
    ptb = _tar(tmp / "ptb.tgz", {
        "s/data/ptb.train.txt": b"a b c a\n b a c\n a a b\n",
        "s/data/ptb.valid.txt": b"c b a\n"})
    f["Imikolov"] = [dict(data_file=ptb, data_type="NGRAM", window_size=3,
                          mode="train", min_word_freq=2),
                     dict(data_file=ptb, data_type="SEQ", mode="test",
                          min_word_freq=1)]
    f["WMT14"] = [dict(data_file=_tar(tmp / "wmt14.tgz", {
        "w/train/a.src": b"hello world\nhello there\n",
        "w/train/a.trg": b"bonjour monde\nsalut toi\n"}), mode="train",
        dict_size=5)]
    f["WMT16"] = [dict(data_file=_tar(tmp / "wmt16.tgz", {
        "wmt16/train.en": b"good day\nday two\n",
        "wmt16/train.de": b"guten tag\ntag zwei\n"}), mode="train",
        src_dict_size=6, trg_dict_size=6, lang=lang)
        for lang in ("en", "de")]
    return f


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


DATASETS = ("UCIHousing", "Imdb", "Movielens", "Conll05st", "Imikolov",
            "WMT14", "WMT16")


@pytest.mark.parametrize("name", DATASETS)
def test_datasets_match_jax(name, tmp_path):
    for kw in _files(tmp_path)[name]:
        got, want = getattr(tds, name)(**kw), getattr(jds, name)(**kw)
        assert len(got) == len(want) > 0, kw
        for i in range(len(got)):
            _same(got[i], want[i])


@pytest.mark.parametrize("name", DATASETS)
def test_datasets_raise_without_a_file(name):
    with pytest.raises(RuntimeError) as t_err:
        getattr(tds, name)(data_file=None)
    with pytest.raises(RuntimeError) as j_err:
        getattr(jds, name)(data_file=None)
    assert str(t_err.value) == str(j_err.value)


# --------------------------------------------------------------- the rest -

def test_softmax_mask_fuse_and_identity_loss_match_jax():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 3, 5, 5)).astype(np.float32)
    mask = np.where(rng.random((2, 1, 5, 5)) < 0.3, -1e4, 0.0).astype(
        np.float32)
    np.testing.assert_allclose(
        tinc.softmax_mask_fuse(torch.tensor(x), torch.tensor(mask)).numpy(),
        _np(jinc.softmax_mask_fuse(jpaddle.to_tensor(x),
                                   jpaddle.to_tensor(mask))), **TOL)
    for dtype in ("float32", "bfloat16"):
        got = tinc.softmax_mask_fuse_upper_triangle(
            tpaddle.to_tensor(x).astype(dtype))
        want = jinc.softmax_mask_fuse_upper_triangle(
            jpaddle.to_tensor(x).astype(dtype))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype("float32").numpy()),
                                   **TOL)
    for red in ("none", "sum", "mean", 0, 1, 2):
        np.testing.assert_allclose(
            tinc.identity_loss(torch.tensor(x), red).numpy(),
            _np(jinc.identity_loss(jpaddle.to_tensor(x), red)), **TOL)


def test_graph_aliases_and_khop_sampler():
    rng = np.random.default_rng(13)
    src = rng.integers(0, 9, 30).astype(np.int64)
    dst = rng.integers(0, 9, 30).astype(np.int64)
    x = rng.standard_normal((9, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tinc.graph_send_recv(torch.tensor(x), torch.tensor(src),
                             torch.tensor(dst), "mean").numpy(),
        _np(jinc.graph_send_recv(jpaddle.to_tensor(x),
                                 jpaddle.to_tensor(src),
                                 jpaddle.to_tensor(dst), "mean")), **TOL)
    # CSC of 20 nodes, each with 0-7 distinct in-neighbours
    rows, colptr = [], [0]
    for _ in range(20):
        d = int(rng.integers(0, 8))
        rows.append(rng.choice(20, size=d, replace=False))
        colptr.append(colptr[-1] + d)
    row = torch.tensor(np.concatenate(rows).astype(np.int64))
    colptr = torch.tensor(np.asarray(colptr, np.int64))
    seeds = torch.tensor([0, 3, 7], dtype=torch.int64)
    r_src, r_dst, nodes = tinc.graph_khop_sampler(row, colptr, seeds, [3, 2])
    assert r_src.shape == r_dst.shape and r_src.dtype == torch.int64
    assert torch.equal(nodes[:3], seeds)
    edges = {(int(a), int(b)) for b in range(20)
             for a in row[colptr[b]:colptr[b + 1]].tolist()}
    for s, d in zip(r_src.tolist(), r_dst.tolist()):
        assert (int(nodes[s]), int(nodes[d])) in edges
    with pytest.raises(NotImplementedError, match="edge ids"):
        tinc.graph_khop_sampler(row, colptr, seeds, [2], return_eids=True)
    assert tinc.graph_reindex is tinc.reindex_graph
    assert set(tinc.__all__) == set(jinc.__all__)


def test_incubate_distributed_raises_naming_its_queue():
    with pytest.raises(NotImplementedError, match="A.12"):
        tinc.distributed.models
