"""The port's ``geometric`` against the JAX package's, on the CPU.

Every message op on the same seeded graph and features in both
packages: ``send_u_recv`` (sum, mean, max, min), ``send_ue_recv``
(each message op with each reduction), ``send_uv`` (each message op)
and the four ``segment_*`` reductions, forward (float32 at rtol = atol
= 1e-6; max, min and integer features exact) and backward (the
gradient of a weighted sum of the output with respect to every float
input, 1e-6). Empty segments give 0 for max and min in float and int,
``out_size`` pads rows, mean divides by the count clamped at 1.
``sample_neighbors`` (unseeded in both packages, as the JAX package
draws it) is held to its properties: every sampled neighbour is an
in-neighbour, the counts are ``min(degree, sample_size)``, nothing is
drawn twice, the edge ids match the neighbours. ``reindex_graph`` and
``reindex_heter_graph`` equal the JAX package's exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpaddle  # noqa: E402
import paddle_tpu.geometric as jgeo  # noqa: E402
import paddle_tpu_torch as tpaddle  # noqa: E402
import paddle_tpu_torch.geometric as tgeo  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-6, atol=1e-6)
N_NODES, N_EDGES, FEAT = 13, 40, 5
MESSAGES = ("add", "sub", "mul", "div")
REDUCES = ("sum", "mean", "max", "min")


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    tpaddle.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _graph(seed=0, n=N_NODES, e=N_EDGES):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int64)
    # the last two nodes receive nothing: empty segments
    dst = rng.integers(0, n - 2, e).astype(np.int64)
    x = rng.standard_normal((n, FEAT)).astype(np.float32)
    y = (rng.standard_normal((e, FEAT)) + 3.0).astype(np.float32)
    w = rng.standard_normal((n + 2, FEAT)).astype(np.float32)
    return src, dst, x, y, w


def _jax(fn, arrays, ints, w):
    """JAX output and the gradients of sum(out * w) by the float
    inputs."""
    ts = [jpaddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts, *[jpaddle.to_tensor(i) for i in ints])
    (out * jpaddle.to_tensor(w[:out.shape[0]])).sum().backward()
    return np.asarray(out.numpy()), [np.asarray(t.grad.numpy()) for t in ts]


def _port(fn, arrays, ints, w):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts, *[torch.tensor(i) for i in ints])
    (out * torch.tensor(w[:out.shape[0]])).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _held(got, want, exact=False):
    out_t, grads_t = got
    out_j, grads_j = want
    if exact:
        np.testing.assert_array_equal(out_t, out_j)
    else:
        np.testing.assert_allclose(out_t, out_j, **TOL)
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("reduce_op", REDUCES)
def test_send_u_recv_matches_jax(reduce_op):
    src, dst, x, _, w = _graph()
    args = ([x], [src, dst], w)
    _held(_port(lambda a, s, d: tgeo.send_u_recv(a, s, d, reduce_op), *args),
          _jax(lambda a, s, d: jgeo.send_u_recv(a, s, d, reduce_op), *args),
          exact=reduce_op in ("max", "min"))


@pytest.mark.parametrize("message_op", MESSAGES)
@pytest.mark.parametrize("reduce_op", REDUCES)
def test_send_ue_recv_matches_jax(message_op, reduce_op):
    src, dst, x, y, w = _graph(1)
    args = ([x, y], [src, dst], w)
    _held(_port(lambda a, b, s, d: tgeo.send_ue_recv(
              a, b, s, d, message_op, reduce_op, out_size=N_NODES + 2),
              *args),
          _jax(lambda a, b, s, d: jgeo.send_ue_recv(
              a, b, s, d, message_op, reduce_op, out_size=N_NODES + 2),
              *args))


@pytest.mark.parametrize("message_op", MESSAGES)
def test_send_uv_matches_jax(message_op):
    src, dst, x, _, w = _graph(2)
    x2 = x + 3.0
    we = np.random.default_rng(3).standard_normal((N_EDGES, FEAT)).astype(
        np.float32)
    args = ([x, x2], [src, dst], we)
    _held(_port(lambda a, b, s, d: tgeo.send_uv(a, b, s, d, message_op),
                *args),
          _jax(lambda a, b, s, d: jgeo.send_uv(a, b, s, d, message_op),
               *args))


@pytest.mark.parametrize("reduce_op", REDUCES)
def test_segment_ops_match_jax(reduce_op):
    rng = np.random.default_rng(4)
    ids = np.sort(rng.integers(0, 6, 20)).astype(np.int64)
    ids[ids == 3] = 4           # segment 3 is empty
    data = rng.standard_normal((20, 3)).astype(np.float32)
    w = rng.standard_normal((7, 3)).astype(np.float32)
    name = f"segment_{reduce_op}"
    got = _port(getattr(tgeo, name), [data], [ids], w)
    _held(got, _jax(getattr(jgeo, name), [data], [ids], w),
          exact=reduce_op in ("max", "min"))
    assert got[0].shape[0] == ids.max() + 1
    if reduce_op in ("max", "min"):
        assert np.all(got[0][3] == 0.0)


@pytest.mark.parametrize("reduce_op", REDUCES)
def test_integer_features_and_empty_segments(reduce_op):
    """int64 features: exact against JAX (mean: the JAX true division);
    the receiver-less rows are 0."""
    src, dst, _, _, _ = _graph(5)
    x = np.random.default_rng(5).integers(-50, 50, (N_NODES, 3)).astype(
        np.int32)
    got = tgeo.send_u_recv(torch.tensor(x), torch.tensor(src),
                           torch.tensor(dst), reduce_op).numpy()
    want = np.asarray(jgeo.send_u_recv(
        jpaddle.to_tensor(x), jpaddle.to_tensor(src), jpaddle.to_tensor(dst),
        reduce_op).numpy())
    assert got.dtype == want.dtype
    if reduce_op == "mean":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)
    assert np.all(got[-2:] == 0)


def test_bad_ops_raise_as_in_jax():
    src, dst, x, y, _ = _graph()
    for pkg in (tgeo, jgeo):
        to = torch.tensor if pkg is tgeo else jpaddle.to_tensor
        with pytest.raises(ValueError, match="unknown reduce_op"):
            pkg.send_u_recv(to(x), to(src), to(dst), "prod")
        with pytest.raises(ValueError, match="unknown message_op"):
            pkg.send_uv(to(x), to(x), to(src), to(dst), "pow")


def _csc(seed=6, n=30, deg_hi=9):
    """A CSC graph: node i has a random in-degree, distinct sources."""
    rng = np.random.default_rng(seed)
    rows, colptr = [], [0]
    for _ in range(n):
        d = int(rng.integers(0, deg_hi))
        rows.append(rng.choice(n, size=d, replace=False))
        colptr.append(colptr[-1] + d)
    return (np.concatenate(rows).astype(np.int64),
            np.asarray(colptr, np.int64))


@pytest.mark.parametrize("sample_size", [-1, 0, 3])
def test_sample_neighbors_properties(sample_size):
    row, colptr = _csc()
    nodes = np.arange(0, 30, 2, dtype=np.int64)
    eids = np.arange(row.size, dtype=np.int64) + 1000
    nbr, cnt, got_eids = tgeo.sample_neighbors(
        torch.tensor(row), torch.tensor(colptr), torch.tensor(nodes),
        sample_size=sample_size, eids=torch.tensor(eids), return_eids=True)
    assert isinstance(nbr, torch.Tensor) and nbr.device.type == "cpu"
    nbr, cnt, got_eids = nbr.numpy(), cnt.numpy(), got_eids.numpy()
    assert cnt.dtype == np.int32 and nbr.size == cnt.sum() == got_eids.size
    at = 0
    for nd, c in zip(nodes, cnt):
        beg, end = colptr[nd], colptr[nd + 1]
        deg = end - beg
        assert c == (deg if sample_size < 0 else min(deg, sample_size))
        picked = nbr[at:at + c]
        assert len(set(picked.tolist())) == c
        assert set(picked.tolist()) <= set(row[beg:end].tolist())
        # each edge id is the id of an edge from its neighbour to nd
        assert np.all(row[got_eids[at:at + c] - 1000] == picked)
        at += c
    with pytest.raises(ValueError, match="requires eids"):
        tgeo.sample_neighbors(torch.tensor(row), torch.tensor(colptr),
                              torch.tensor(nodes), return_eids=True)


def test_reindex_graph_matches_jax():
    rng = np.random.default_rng(7)
    x = np.array([5, 9, 2, 9], np.int64)
    nbr = rng.integers(0, 12, 11).astype(np.int64)
    cnt = np.array([3, 2, 4, 2], np.int32)
    got = tgeo.reindex_graph(torch.tensor(x), torch.tensor(nbr),
                             torch.tensor(cnt))
    want = jgeo.reindex_graph(jpaddle.to_tensor(x), jpaddle.to_tensor(nbr),
                              jpaddle.to_tensor(cnt))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()))
    nbr2 = rng.integers(0, 15, 6).astype(np.int64)
    cnt2 = np.array([1, 2, 0, 3], np.int32)
    got = tgeo.reindex_heter_graph(
        torch.tensor(x), [torch.tensor(nbr), torch.tensor(nbr2)],
        [torch.tensor(cnt), torch.tensor(cnt2)])
    want = jgeo.reindex_heter_graph(
        jpaddle.to_tensor(x), [jpaddle.to_tensor(nbr),
                               jpaddle.to_tensor(nbr2)],
        [jpaddle.to_tensor(cnt), jpaddle.to_tensor(cnt2)])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()))
