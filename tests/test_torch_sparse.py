"""The port's ``sparse`` against the JAX package's, on the CPU.

Each case of ``tests/test_sparse.py`` runs in both packages on the same
numpy inputs (written once against the shared Paddle API), and the
port's results are held to the JAX package's: values, patterns
(indices exactly), gradients into the values and into the dense
operand. Float32 at rtol = atol = 1e-6 (the same sums in another
order), the 3-D convolutions at 1e-5 (XLA's and PyTorch's convolution
sum 81 products in different orders). The layers' weights cross from
the JAX layer as numpy (``layer_state_from_jax``). On top: the
pattern of a plain conv keeps a site whose features are all zero, the
max pool never lets an implicit zero win over negative values, and a
port ``Tensor``'s ``to_sparse_coo(2)`` / ``to_sparse_csr()`` give the
port's sparse tensors while a plain ``torch.Tensor`` keeps torch's
methods of those names.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.nn.layer.layers import layer_state_from_jax  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-6, atol=1e-6)
CONV_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    return np.asarray(x.numpy())


def _example():
    dense = np.zeros((3, 4), "float32")
    dense[0, 1] = 1.0
    dense[1, 0] = 2.0
    dense[1, 3] = 3.0
    dense[2, 2] = -4.0
    idx = np.stack(np.nonzero(dense))
    return dense, idx, dense[tuple(idx)]


def _both(case, tol=TOL):
    """``case(p)`` in both packages; every array of the port's result
    held to the JAX package's (integer arrays exactly)."""
    want, got = case(jp), case(tp)
    assert want.keys() == got.keys()
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, k
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **tol)
    return got


def _coo(p, dense=None):
    d, idx, vals = _example()
    return p.sparse_coo_tensor(idx, vals, d.shape)


# ----------------------------------------------------------- creation --

def test_coo_roundtrip():
    def case(p):
        st = _coo(p)
        assert st.is_sparse_coo() and not st.is_sparse_csr()
        assert st.nnz() == 4 and st.shape == [3, 4]
        return {"dense": _np(st.to_dense()), "idx": _np(st.indices())}
    got = _both(case)
    np.testing.assert_array_equal(got["dense"], _example()[0])


def test_coo_infer_shape():
    def case(p):
        _, idx, vals = _example()
        return {"shape": np.asarray(p.sparse_coo_tensor(idx, vals).shape)}
    np.testing.assert_array_equal(_both(case)["shape"], [3, 4])


def test_csr_roundtrip():
    def case(p):
        st = p.sparse_csr_tensor([0, 1, 3, 4], [1, 0, 3, 2],
                                 [1.0, 2.0, 3.0, -4.0], [3, 4])
        assert st.is_sparse_csr()
        return {"dense": _np(st.to_dense())}
    np.testing.assert_array_equal(_both(case)["dense"], _example()[0])


def test_coo_csr_conversion():
    def case(p):
        csr = _coo(p).to_sparse_csr()
        back = csr.to_sparse_coo()
        return {"csr": _np(csr.to_dense()), "crows": _np(csr.crows()),
                "cols": _np(csr.cols()), "back": _np(back.to_dense()),
                "back_idx": _np(back.indices())}
    _both(case)


def test_dense_to_sparse():
    def case(p):
        t = p.to_tensor(_example()[0])
        st = t.to_sparse_coo(2)
        assert st.nnz() == 4
        return {"coo": _np(st.to_dense()), "idx": _np(st.indices()),
                "csr": _np(t.to_sparse_csr().to_dense())}
    _both(case)


def test_coalesce_sums_duplicates():
    def case(p):
        idx = np.array([[0, 0, 1], [1, 1, 2]])
        c = p.sparse.coalesce(p.sparse_coo_tensor(idx, [1.0, 2.0, 5.0],
                                                  [2, 3]))
        assert c.nnz() == 2
        return {"dense": _np(c.to_dense()), "idx": _np(c.indices()),
                "vals": _np(c.values())}
    got = _both(case)
    assert got["dense"][0, 1] == 3.0 and got["dense"][1, 2] == 5.0


# -------------------------------------------------------------- unary --

def test_values_ops():
    def case(p):
        st, s = _coo(p), p.sparse
        return {"abs": _np(s.abs(st).to_dense()),
                "relu": _np(s.relu(st).to_dense()),
                "neg": _np(s.neg(st).to_dense()),
                "scale": _np(s.scale(st, 2.0).to_dense()),
                "pow": _np(s.pow(st, 2).to_dense()),
                "sin": _np(s.sin(st).values()),
                "tanh": _np(s.tanh(st).values()),
                "expm1": _np(s.expm1(st).values()),
                "leaky": _np(s.leaky_relu(st, 0.2).values()),
                "relu6": _np(s.relu6(s.scale(st, 3.0)).values()),
                "deg2rad": _np(s.deg2rad(st).values())}
    got = _both(case)
    dense = _example()[0]
    np.testing.assert_allclose(got["pow"], dense ** 2, rtol=1e-6)


def test_cast():
    def case(p):
        out = p.sparse.cast(_coo(p), value_dtype="float64",
                            index_dtype="int32")
        assert "float" in str(out.values().dtype)
        assert "int32" in str(out.indices().dtype)
        return {"vals": _np(out.values())}
    _both(case)


def test_grad_flows_to_values():
    def case(p):
        _, idx, vals = _example()
        v = p.to_tensor(vals)
        v.stop_gradient = False
        st = p.sparse.SparseCooTensor(p.to_tensor(idx.astype("int64")), v,
                                      [3, 4])
        p.sparse.relu(st).to_dense().sum().backward()
        return {"grad": _np(v.grad)}
    got = _both(case)
    np.testing.assert_allclose(got["grad"],
                               (_example()[2] > 0).astype("float32"))


# ------------------------------------------------------------- binary --

def test_add_same_pattern():
    def case(p):
        dense, idx, vals = _example()
        a = p.sparse_coo_tensor(idx, vals, dense.shape)
        b = p.sparse_coo_tensor(idx, 2 * vals, dense.shape)
        return {"sum": _np((a + b).to_dense())}
    np.testing.assert_allclose(_both(case)["sum"], 3 * _example()[0])


def test_add_different_pattern():
    def case(p):
        dense, idx, vals = _example()
        a = p.sparse_coo_tensor(idx, vals, dense.shape)
        other = np.zeros_like(dense)
        other[0, 0] = 7.0
        b = p.to_tensor(other).to_sparse_coo(2)
        s = a + b
        return {"add": _np(s.to_dense()), "idx": _np(s.indices()),
                "sub": _np(p.sparse.subtract(a, b).to_dense())}
    _both(case)


def test_multiply_divide():
    def case(p):
        dense, idx, vals = _example()
        a = p.sparse_coo_tensor(idx, vals, dense.shape)
        b = p.sparse_coo_tensor(idx, np.full_like(vals, 2.0), dense.shape)
        return {"mul": _np(p.sparse.multiply(a, b).to_dense()),
                "div": _np(p.sparse.divide(a, b).to_dense()),
                "mul3": _np(p.sparse.multiply(a, 3.0).to_dense())}
    _both(case)


# ------------------------------------------------------------- matmul --

Y = np.random.default_rng(3).standard_normal((4, 5)).astype("float32")


def _matmul_grads(p, csr):
    _, idx, vals = _example()
    v = p.to_tensor(vals)
    v.stop_gradient = False
    st = p.sparse.SparseCooTensor(p.to_tensor(idx.astype("int64")), v,
                                  [3, 4])
    if csr:
        st = st.to_sparse_csr()
    y = p.to_tensor(Y)
    y.stop_gradient = False
    out = p.sparse.matmul(st, y)
    w = np.random.default_rng(4).standard_normal((3, 5)).astype("float32")
    (out * p.to_tensor(w)).sum().backward()
    return {"out": _np(out), "dv": _np(v.grad), "dy": _np(y.grad)}


def test_coo_matmul():
    got = _both(lambda p: _matmul_grads(p, csr=False))
    np.testing.assert_allclose(got["out"], _example()[0] @ Y, rtol=1e-5)


def test_csr_matmul():
    def case(p):
        st = p.to_tensor(_example()[0]).to_sparse_csr()
        return {"out": _np(st @ p.to_tensor(Y)),
                **_matmul_grads(p, csr=True)}
    got = _both(case)
    np.testing.assert_allclose(got["out"], _example()[0] @ Y, rtol=1e-5)


def test_matmul_grad():
    def case(p):
        _, idx, vals = _example()
        v = p.to_tensor(vals)
        v.stop_gradient = False
        st = p.sparse.SparseCooTensor(p.to_tensor(idx.astype("int64")), v,
                                      [3, 4])
        y = p.to_tensor(Y)
        y.stop_gradient = False
        p.sparse.matmul(st, y).sum().backward()
        return {"dv": _np(v.grad), "dy": _np(y.grad)}
    got = _both(case)
    np.testing.assert_allclose(
        got["dy"], np.repeat(_example()[0].sum(0)[:, None], 5, 1),
        rtol=1e-5)


def test_masked_matmul():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 6)).astype("float32")
    y = rng.standard_normal((6, 4)).astype("float32")

    def case(p):
        dense, idx, vals = _example()
        mask = p.sparse_coo_tensor(idx, np.ones_like(vals), dense.shape)
        out = p.sparse.masked_matmul(p.to_tensor(x), p.to_tensor(y), mask)
        csr = p.sparse.masked_matmul(p.to_tensor(x), p.to_tensor(y),
                                     mask.to_sparse_csr())
        return {"coo": _np(out.to_dense()), "csr": _np(csr.to_dense())}
    got = _both(case)
    dense, idx, _ = _example()
    expect = np.zeros_like(dense)
    expect[tuple(idx)] = (x @ y)[tuple(idx)]
    np.testing.assert_allclose(got["coo"], expect, rtol=1e-5)


def test_addmm_mv():
    rng = np.random.default_rng(6)
    inp = rng.standard_normal((3, 5)).astype("float32")
    vec = rng.standard_normal(4).astype("float32")

    def case(p):
        st = _coo(p)
        return {"addmm": _np(p.sparse.addmm(p.to_tensor(inp), st,
                                            p.to_tensor(Y), beta=0.5,
                                            alpha=2.0)),
                "mv": _np(p.sparse.mv(st, p.to_tensor(vec)))}
    got = _both(case)
    dense = _example()[0]
    np.testing.assert_allclose(got["addmm"], 0.5 * inp + 2 * (dense @ Y),
                               rtol=1e-5)
    np.testing.assert_allclose(got["mv"], dense @ vec, rtol=1e-5)


# ---------------------------------------------------------- structure --

def test_transpose_reshape():
    def case(p):
        st = _coo(p)
        return {"t": _np(p.sparse.transpose(st, [1, 0]).to_dense()),
                "r": _np(p.sparse.reshape(st, [2, 6]).to_dense()),
                "r_idx": _np(p.sparse.reshape(st, [-1, 2]).indices())}
    got = _both(case)
    np.testing.assert_array_equal(got["t"], _example()[0].T)


def test_softmax():
    def case(p):
        st = _coo(p)
        return {"coo": _np(p.sparse.softmax(st).to_dense()),
                "csr": _np(p.sparse.softmax(st.to_sparse_csr()).to_dense())}
    got = _both(case)
    e = np.exp(np.array([2.0, 3.0]) - 3.0)
    np.testing.assert_allclose(got["coo"][1, [0, 3]], e / e.sum(), rtol=1e-5)
    assert got["coo"][0, 1] == pytest.approx(1.0)


def test_sum():
    def case(p):
        return {"sum": _np(p.sparse.sum(_coo(p)))}
    np.testing.assert_allclose(_both(case)["sum"], _example()[0].sum())


# ------------------------------------------------- review regressions --

def test_divide_pattern_mismatch_raises():
    for p in (jp, tp):
        a = p.sparse_coo_tensor([[0, 1], [0, 1]], [2.0, 4.0], [2, 2])
        b = p.sparse_coo_tensor([[0], [0]], [2.0], [2, 2])
        with pytest.raises(ValueError):
            p.sparse.divide(a, b)


def _cross(jlayer, tlayer):
    return layer_state_from_jax(
        {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()},
        tlayer)


def test_conv_pattern_keeps_zero_valued_sites():
    idx = np.array([[0, 0], [1, 2], [1, 2], [1, 2]])
    vals = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], "float32")
    jconv = jp.sparse.nn.Conv3D(3, 2, 1)
    tconv = _cross(jconv, tp.sparse.nn.Conv3D(3, 2, 1))

    def case(p):
        conv = jconv if p is jp else tconv
        st = p.sparse.SparseCooTensor(p.to_tensor(idx.astype("int64")),
                                      p.to_tensor(vals), [1, 4, 4, 4, 3])
        out = conv(st)
        assert out.nnz() == 2
        return {"idx": _np(out.indices()), "vals": _np(out.values())}
    _both(case, CONV_TOL)


def test_maxpool_negative_values():
    def case(p):
        idx = np.array([[0], [0], [0], [0]])
        st = p.sparse.SparseCooTensor(
            p.to_tensor(idx.astype("int64")),
            p.to_tensor(np.array([[-3.0]], "float32")), [1, 2, 2, 2, 1])
        out = p.sparse.nn.MaxPool3D(2, 2)(st)
        return {"vals": _np(out.values()), "idx": _np(out.indices())}
    assert float(_both(case)["vals"][0, 0]) == -3.0


# ------------------------------------------------------------ sparse nn --

def _cloud(n=20, c=3, seed=0):
    rng = np.random.default_rng(seed)
    dense = np.zeros((1, 4, 4, 4, c), "float32")
    for s in rng.integers(0, 4, size=(n, 3)):
        dense[0, s[0], s[1], s[2]] = rng.normal(size=c).astype("float32")
    return dense


def test_activation_layers():
    def case(p):
        st = p.to_tensor(_cloud()).to_sparse_coo(4)
        return {"relu": _np(p.sparse.nn.ReLU()(st).to_dense()),
                "relu6": _np(p.sparse.nn.ReLU6()(st).values()),
                "leaky": _np(p.sparse.nn.LeakyReLU(0.1)(st).values())}
    np.testing.assert_allclose(_both(case)["relu"], np.maximum(_cloud(), 0))


def test_batchnorm():
    jbn = jp.sparse.nn.BatchNorm(3)
    tbn = _cross(jbn, tp.sparse.nn.BatchNorm(3))

    def case(p):
        bn = jbn if p is jp else tbn
        st = p.to_tensor(_cloud()).to_sparse_coo(4)
        out = bn(st)
        return {"vals": _np(out.values()),
                "mean": _np(bn.state_dict()["_bn._mean"]),
                "var": _np(bn.state_dict()["_bn._variance"])}
    got = _both(case, dict(rtol=1e-5, atol=1e-6))
    assert abs(got["vals"].mean()) < 0.2


def _conv_case(jconv, tconv):
    def case(p):
        conv = jconv if p is jp else tconv
        st = p.to_tensor(_cloud()).to_sparse_coo(4)
        st.stop_gradient = False
        out = conv(st)
        w = np.random.default_rng(9).standard_normal(
            tuple(out.values().shape)).astype("float32")
        (out.values() * p.to_tensor(w)).sum().backward()
        return {"idx": _np(out.indices()), "vals": _np(out.values()),
                "shape": np.asarray(out.shape), "dw": _np(conv.weight.grad),
                "db": _np(conv.bias.grad), "dx": _np(st.values().grad)}
    return _both(case, CONV_TOL)


def test_subm_conv3d_preserves_pattern():
    jconv = jp.sparse.nn.SubmConv3D(3, 8, 3, padding=1)
    got = _conv_case(jconv, _cross(jconv, tp.sparse.nn.SubmConv3D(
        3, 8, 3, padding=1)))
    st = tp.to_tensor(_cloud()).to_sparse_coo(4)
    np.testing.assert_array_equal(got["idx"], _np(st.indices()))
    assert got["shape"][-1] == 8


def test_conv3d_matches_dense():
    jconv = jp.sparse.nn.Conv3D(3, 4, 3, padding=1)
    tconv = _cross(jconv, tp.sparse.nn.Conv3D(3, 4, 3, padding=1))
    got = _conv_case(jconv, tconv)
    w = tconv.weight.detach()
    ref = torch.nn.functional.conv3d(
        torch.tensor(_cloud()).permute(0, 4, 1, 2, 3),
        w.permute(4, 3, 0, 1, 2), padding=1).permute(0, 2, 3, 4, 1)
    ref = ref.numpy() + tconv.bias.detach().numpy()
    np.testing.assert_allclose(got["vals"], ref[tuple(got["idx"])],
                               **CONV_TOL)


def test_maxpool3d():
    def case(p):
        st = p.to_tensor(_cloud()).to_sparse_coo(4)
        out = p.sparse.nn.MaxPool3D(2, 2)(st)
        return {"idx": _np(out.indices()), "vals": _np(out.values()),
                "shape": np.asarray(out.shape)}
    np.testing.assert_array_equal(_both(case)["shape"][1:4], [2, 2, 2])


def test_conv_grad():
    jconv = jp.sparse.nn.SubmConv3D(3, 4, 3, padding=1)
    got = _conv_case(jconv, _cross(jconv, tp.sparse.nn.SubmConv3D(
        3, 4, 3, padding=1)))
    assert np.abs(got["dw"]).sum() > 0


# ----------------------------------- the port Tensor's sparse methods --

def test_port_tensor_methods_take_paddles_meaning():
    dense = _example()[0]
    t = tp.to_tensor(dense)
    coo, csr = t.to_sparse_coo(2), t.to_sparse_csr()
    assert isinstance(coo, tp.sparse.SparseCooTensor)
    assert isinstance(csr, tp.sparse.SparseCsrTensor)
    np.testing.assert_array_equal(_np(coo.to_dense()), dense)
    np.testing.assert_array_equal(_np(csr.crows()), [0, 1, 3, 4])
    # a plain torch.Tensor keeps torch's methods
    plain = torch.tensor(dense)
    assert plain.to_sparse_coo().layout == torch.sparse_coo
    assert plain.to_sparse_csr().layout == torch.sparse_csr
