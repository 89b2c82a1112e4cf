"""The port's top-level op surface against the JAX package's, on the CPU.

One parametrised case per op of ``chip_smoke.OP_SWEEP`` (the table the
smoke sweeps on the card, written against the Paddle API of either
package): the same numpy inputs (``np.random`` seeded per case) go
through ``paddle_tpu`` and ``paddle_tpu_torch``.
Tolerances: float32 results within rtol 1e-5 / atol 1e-5 (the same
arithmetic in another order and other libm routines), integer and
boolean results exact (the JAX package runs without x64: its int64 is
int32, so only values are compared). Decompositions are compared by
reconstruction and by their sorted spectra (LAPACK and XLA fix signs
and phases differently), random draws by shape, dtype, range, moments
and reproducibility under ``paddle.seed`` (the port draws from torch
generators, the JAX package from threefry keys). A last test lists the
JAX package's public names the port still lacks at the top level, in
``paddle.nn``, ``paddle.nn.functional`` and ``paddle.linalg``, each
with the ROADMAP item that ports it.
"""
import importlib.util
import re
import types
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.linalg as jlinalg  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from chip_smoke import OP_SWEEP, op_inputs  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-5
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(a) for a in x]
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _close(got, want, name):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), name
        for g, w in zip(got, want):
            _close(g, w, name)
        return
    assert tuple(got.shape) == tuple(want.shape), (name, got.shape,
                                                   want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("name", sorted(OP_SWEEP))
def test_op_matches_jax(name):
    d = op_inputs(zlib.crc32(name.encode()) % 1000)
    want = _np(OP_SWEEP[name](jp, d))
    got = OP_SWEEP[name](tp, d)
    if isinstance(got, torch.Tensor):
        assert got.device.type == "cpu"
    _close(_np(got), want, name)


# ------------------------------------------------------- decompositions --


def _recon(name, p, a):
    t = p.to_tensor(a)
    if name == "qr":
        q, r = p.qr(t)
        return _np(p.matmul(q, r))
    if name == "svd":
        u, s, v = p.svd(t)
        return _np(u) * _np(s)[None] @ _np(v).T
    if name == "eigh":
        w, v = p.eigh(t)
        return _np(v) * _np(w)[None] @ _np(v).T
    if name == "eig":
        w, v = p.eig(t)
        v = _np(v)
        return np.real(v * _np(w)[None] @ np.linalg.inv(v))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["qr", "svd", "eigh", "eig"])
def test_decompositions_reconstruct(name):
    d = op_inputs(3)
    a = d["spd"] if name == "eigh" else d["m"]
    for p in (jp, tp):
        np.testing.assert_allclose(_recon(name, p, a), a, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", ["svd", "eigh", "eigvals"])
def test_spectra_match_jax(name):
    a = op_inputs(4)["spd"]
    fn = {"svd": lambda p, t: p.svd(t)[1],
          "eigh": lambda p, t: p.eigh(t)[0],
          "eigvals": lambda p, t: p.eigvals(t)}[name]
    spectra = [np.sort(np.real(_np(fn(p, p.to_tensor(a))))) for p in
               (jp, tp)]
    np.testing.assert_allclose(spectra[1], spectra[0], rtol=1e-5, atol=1e-5)


def test_lstsq_rank_and_singular_values():
    d = op_inputs(6)
    a = np.concatenate([d["m"], d["f"]])
    b = np.stack([np.concatenate([d["v"], d["w"][:3]])] * 2, 1)
    j = [_np(o) for o in jp.lstsq(jp.to_tensor(a), jp.to_tensor(b))]
    t = [_np(o) for o in tp.lstsq(tp.to_tensor(a), tp.to_tensor(b))]
    for g, w in zip(t, j):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ random ops --


RANDOM = {
    "uniform": (lambda p: p.uniform([4000], min=-2.0, max=3.0),
                "float32", (-2.0, 3.0), 0.5, (25 / 12) ** 0.5),
    "rand": (lambda p: p.rand([4000]), "float32", (0.0, 1.0), 0.5,
             (1 / 12) ** 0.5),
    "randn": (lambda p: p.randn([4000]), "float32", None, 0.0, 1.0),
    "standard_normal": (lambda p: p.standard_normal([4000]), "float32",
                        None, 0.0, 1.0),
    "normal": (lambda p: p.normal(1.0, 2.0, [4000]), "float32", None, 1.0,
               2.0),
    "randint": (lambda p: p.randint(0, 10, [4000]), "int64", (0, 9), 4.5,
                (99 / 12) ** 0.5),
    "randint_like": (lambda p: p.randint_like(p.zeros([4000], "int64"), 0,
                                              4), "int64", (0, 3), 1.5,
                     (15 / 12) ** 0.5),
    "randperm": (lambda p: p.randperm(4000), "int64", (0, 3999), 1999.5,
                 None),
    "bernoulli": (lambda p: p.bernoulli(p.full([4000], 0.3)), "float32",
                  (0.0, 1.0), 0.3, (0.21) ** 0.5),
    "poisson": (lambda p: p.poisson(p.full([4000], 3.0)), "float32",
                (0.0, None), 3.0, 3.0 ** 0.5),
    "multinomial": (lambda p: p.multinomial(p.to_tensor(
        np.array([0.1, 0.2, 0.7], "float32")), 2000, replacement=True),
        "int64", (0, 2), 1.6, None),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_op_shape_dtype_moments_and_seed(name):
    fn, dtype, rng, mean, std = RANDOM[name]
    tp.seed(11)
    a = fn(tp)
    tp.seed(11)
    b = fn(tp)
    j = _np(fn(jp))
    x = _np(a)
    assert x.shape == j.shape
    assert str(a.dtype).split(".")[-1] == dtype
    np.testing.assert_array_equal(x, _np(b))         # reproducible
    assert not np.array_equal(x, _np(fn(tp)))        # the stream moves on
    if rng is not None:
        assert x.min() >= rng[0]
        if rng[1] is not None:
            assert x.max() <= rng[1]
    n = x.size
    sd = std if std is not None else x.std()
    assert abs(x.mean() - mean) < 5 * sd / n ** 0.5, (x.mean(), mean)
    if std is not None:
        assert abs(x.std() - std) < 0.1 * std
    assert abs(x.mean() - j.mean()) < 10 * sd / n ** 0.5


def test_multinomial_without_replacement_and_seeded_uniform():
    tp.seed(3)
    probs = tp.to_tensor(np.array([[0.2, 0.3, 0.5, 0.0]] * 3, "float32"))
    out = _np(tp.multinomial(probs, 3))
    assert out.shape == (3, 3)
    for row in out:
        assert sorted(row.tolist()) == [0, 1, 2]     # distinct, never 3
    a = _np(tp.uniform([5], seed=7))
    np.testing.assert_array_equal(a, _np(tp.uniform([5], seed=7)))


# ---------------------------------------------------- the public surface --


# the JAX package's public names the port does not have yet, with the
# ROADMAP item that ports each; everything else must be present
LATER = {
    "A.10.7b": {
        # compat.py
        "CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "DataParallel",
        "LazyGuard", "NPUPlace", "Place", "TPUPlace", "batch", "check_shape",
        "create_parameter", "disable_signal_handler", "dtype",
        "get_cuda_rng_state", "iinfo", "is_compiled_with_tpu", "is_complex",
        "is_floating_point", "is_integer", "set_cuda_rng_state",
        "set_printoptions",
        # sparse, the long-tail modules
        "sparse_coo_tensor", "sparse_csr_tensor", "audio", "compat",
        "cost_model", "distribution", "fft", "hub", "onnx", "profiler",
        "quantization", "reader", "signal", "sparse", "strings",
        "sysconfig"},
    "A.11": {"distributed"},
}
# the JAX modules' own imports and helpers, which are not Paddle's API
NOT_API = {"annotations", "apply", "defop", "make_op", "register_op",
           "to_tensor_arg", "jax", "jnp", "np", "Tensor", "creation", "logic",
           "manipulation", "math", "nn_ops", "random_ops", "reduction"}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_public_names_cover_the_jax_package():
    later = set().union(*LATER.values())
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for item in LATER:
        assert re.search(rf"\*\*{re.escape(item)}\*\*", roadmap) or \
            item in roadmap, item
    pairs = [(jp, tp), (jp.nn, tp.nn),
             (jp.nn.functional, tp.nn.functional), (jlinalg, tp.linalg)]
    missing = set()
    for j, t in pairs:
        missing |= _public(j) - _public(t)
    missing -= NOT_API
    # a subpackage the port has counts, imported at the top level or not
    # (which depends on what else the process imported)
    missing = {n for n in missing if importlib.util.find_spec(
        f"paddle_tpu_torch.{n}") is None}
    assert missing <= later, sorted(missing - later)
    # the list holds no name the port has since gained
    assert not (later & _public(tp)), sorted(later & _public(tp))
    assert isinstance(tp.linalg, types.ModuleType)
