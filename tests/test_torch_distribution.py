"""The port's ``distribution`` against the JAX package's, on the CPU.

Each case of ``tests/test_distribution.py`` runs in both packages on the
same inputs and the port's results are held to the JAX package's:
densities, CDFs, entropies, means, variances and KLs at rtol = atol =
1e-6 (float32: the same formulas, XLA's and PyTorch's ``log`` / ``exp``
/ ``erf`` / ``lgamma`` / ``digamma`` may differ in the last place), and
every registered KL pair beside them. Draws from the threefry stream
(Normal, Uniform, Laplace, Gumbel, Exponential, Categorical,
Multinomial, Bernoulli) are held to the JAX package's on the same
``paddle.seed``: the integer draws exactly, the float draws at rtol =
atol = 1e-5 (the uniforms are the same bits; ``torch.erfinv`` and
``log`` differ from XLA's in the last places, and ``erfinv`` near
``|u| = 1`` magnifies that: 20,000 normal draws differ by up to 6.3e-6
relative, at a draw of 9.3). Gamma
draws (Beta, Dirichlet) come from PyTorch's generator, not the key, so
they are held by their moments. Gradients of ``rsample`` and of a
log-density flow back to the parameters as in the JAX package.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-6, atol=1e-6)
DRAW_TOL = dict(rtol=1e-5, atol=1e-5)
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    return np.asarray(x.numpy())


def _both(case, tol=TOL, seed=None):
    """``case(p)`` in both packages (each reseeded first when ``seed``);
    the port's arrays held to the JAX package's."""
    outs = []
    for p in (jp, tp):
        if seed is not None:
            p.seed(seed)
        outs.append(case(p))
    want, got = outs
    assert want.keys() == got.keys()
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if a.dtype.kind in "iub" or b.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            t = DRAW_TOL if k.startswith("draw") else tol
            np.testing.assert_allclose(a, b, err_msg=k, **t)
    return got


def f32(x):
    return np.asarray(x, np.float32)


def test_normal_log_prob_entropy():
    def case(p):
        d = p.distribution.Normal(1.5, 2.0)
        v = p.to_tensor(f32([0.0, 1.5, 3.0]))
        return {"lp": _np(d.log_prob(v)), "ent": _np(d.entropy()),
                "cdf": _np(d.cdf(p.to_tensor(f32(1.5)))),
                "icdf": _np(d.icdf(p.to_tensor(f32([0.1, 0.5, 0.9])))),
                "mean": _np(d.mean), "var": _np(d.variance),
                "prob": _np(d.prob(v))}
    got = _both(case)
    v = f32([0.0, 1.5, 3.0])
    ref = (-((v - 1.5) ** 2) / 8 - math.log(2.0)
           - 0.5 * math.log(2 * math.pi))
    np.testing.assert_allclose(got["lp"], ref, rtol=RTOL)
    np.testing.assert_allclose(got["cdf"], 0.5, atol=1e-6)


def test_normal_sampling_moments():
    def case(p):
        d = p.distribution.Normal(p.to_tensor(f32(2.0)),
                                  p.to_tensor(f32(3.0)))
        return {"draw": _np(d.sample([20000]))}
    s = _both(case, seed=0)["draw"]
    assert abs(s.mean() - 2.0) < 0.1 and abs(s.std() - 3.0) < 0.1


def test_normal_rsample_grad():
    def case(p):
        loc = p.to_tensor(f32(0.5), stop_gradient=False)
        scale = p.to_tensor(f32(1.5), stop_gradient=False)
        s = p.distribution.Normal(loc, scale).rsample([1000])
        s.mean().backward()
        return {"draw": _np(s), "dloc": _np(loc.grad),
                "dscale": _np(scale.grad)}
    got = _both(case, seed=1)
    np.testing.assert_allclose(got["dloc"], 1.0, rtol=1e-4)


def test_uniform():
    def case(p):
        d = p.distribution.Uniform(1.0, 3.0)
        return {"lp": _np(d.log_prob(p.to_tensor(f32([2.0, 5.0])))),
                "ent": _np(d.entropy()), "mean": _np(d.mean),
                "var": _np(d.variance), "draw": _np(d.sample([5000]))}
    got = _both(case, seed=2)
    np.testing.assert_allclose(got["lp"][0], -math.log(2.0), rtol=RTOL)
    assert np.isinf(got["lp"][1])
    assert got["draw"].min() >= 1.0 and got["draw"].max() < 3.0


def test_laplace():
    def case(p):
        d = p.distribution.Laplace(0.0, 2.0)
        c = d.cdf(p.to_tensor(f32(0.7)))
        return {"lp": _np(d.log_prob(p.to_tensor(f32(1.0)))),
                "ent": _np(d.entropy()), "var": _np(d.variance),
                "std": _np(d.stddev), "cdf": _np(c),
                "icdf": _np(d.icdf(c)), "draw": _np(d.sample([4000]))}
    got = _both(case, seed=3)
    np.testing.assert_allclose(got["lp"], -0.5 - math.log(4.0), rtol=RTOL)
    np.testing.assert_allclose(got["icdf"], 0.7, rtol=1e-4)


def test_gumbel():
    def case(p):
        d = p.distribution.Gumbel(1.0, 2.0)
        return {"mean": _np(d.mean), "var": _np(d.variance),
                "ent": _np(d.entropy()),
                "lp": _np(d.log_prob(p.to_tensor(f32([0.0, 2.0])))),
                "cdf": _np(d.cdf(p.to_tensor(f32([0.0, 2.0])))),
                "draw": _np(d.sample([20000]))}
    got = _both(case, seed=3)
    assert abs(got["draw"].mean() - float(got["mean"])) < 0.1


def test_beta_dirichlet():
    conc = f32([1.0, 2.0, 3.0])

    def case(p):
        d = p.distribution.Beta(2.0, 3.0)
        dd = p.distribution.Dirichlet(p.to_tensor(conc))
        return {"mean": _np(d.mean), "var": _np(d.variance),
                "lp": _np(d.log_prob(p.to_tensor(f32(0.4)))),
                "ent": _np(d.entropy()), "dmean": _np(dd.mean),
                "dvar": _np(dd.variance), "dent": _np(dd.entropy()),
                "dlp": _np(dd.log_prob(p.to_tensor(f32([0.2, 0.3, 0.5]))))}
    got = _both(case)
    ref = math.log(0.4) + 2 * math.log(0.6) - math.log(1 / 12)
    np.testing.assert_allclose(got["lp"], ref, rtol=1e-4)
    # gamma draws: the port's own generator, held by their moments
    tp.seed(4)
    s = _np(tp.distribution.Beta(2.0, 3.0).sample([20000]))
    assert abs(s.mean() - 0.4) < 0.02
    s = _np(tp.distribution.Dirichlet(tp.to_tensor(conc)).sample([4000]))
    np.testing.assert_allclose(s.sum(-1), 1.0, rtol=1e-5)
    assert np.abs(s.mean(0) - conc / conc.sum()).max() < 0.02


def test_categorical_multinomial():
    logits = np.log(f32([0.2, 0.3, 0.5]))

    def case(p):
        d = p.distribution.Categorical(p.to_tensor(logits))
        m = p.distribution.Multinomial(10, p.to_tensor(f32([0.2, 0.3, 0.5])))
        return {"lp": _np(d.log_prob(p.to_tensor(np.array(2)))),
                "ent": _np(d.entropy()), "probs": _np(d.probs),
                "draw_cat": _np(d.sample([20000])).astype(np.int64),
                "draw_multi": _np(m.sample([200])),
                "mlp": _np(m.log_prob(p.to_tensor(f32([2.0, 3.0, 5.0])))),
                "mmean": _np(m.mean), "mvar": _np(m.variance)}
    got = _both(case, seed=5)
    np.testing.assert_allclose(got["lp"], math.log(0.5), rtol=1e-5)
    freqs = np.bincount(got["draw_cat"], minlength=3) / 20000
    assert np.abs(freqs - [0.2, 0.3, 0.5]).max() < 0.02
    np.testing.assert_allclose(got["draw_multi"].sum(-1), 10.0)


def test_multinomial_entropy_exact():
    def case(p):
        m = p.distribution.Multinomial(10, p.to_tensor(f32([0.5, 0.5])))
        return {"ent": _np(m.entropy())}
    ref = 0.0
    for k in range(11):
        lp = (math.lgamma(11) - math.lgamma(k + 1) - math.lgamma(11 - k)
              + 10 * math.log(0.5))
        ref -= math.exp(lp) * lp
    np.testing.assert_allclose(float(_both(case, dict(rtol=1e-5, atol=1e-6))
                                     ["ent"]), ref, rtol=1e-4)


def test_chain_transform_type():
    for p in (jp, tp):
        D = p.distribution
        from importlib import import_module
        Type = import_module(D.__name__ + ".transform").Type
        c = D.ChainTransform([D.ExpTransform(), D.AffineTransform(0.0, 2.0)])
        assert c._type == Type.BIJECTION and c._is_injective()
        assert not D.ChainTransform([D.AbsTransform(),
                                     D.ExpTransform()])._is_injective()


def test_chain_event_dims_and_multi_transform():
    def case(p):
        D = p.distribution
        base = D.Normal(p.to_tensor(np.zeros(3, np.float32)),
                        p.to_tensor(np.ones(3, np.float32)))
        td = D.TransformedDistribution(
            base, [D.StickBreakingTransform(), D.ExpTransform()])
        assert td.batch_shape == [] and td.event_shape == [4]
        s = td.rsample()
        return {"draw": _np(s), "lp": _np(td.log_prob(s))}
    got = _both(case, dict(rtol=2e-5, atol=2e-5), seed=13)
    assert got["draw"].shape == (4,) and np.isfinite(got["lp"])


def test_sample_seed_determinism():
    def case(p):
        d = p.distribution.Normal(0.0, 1.0)
        return {"draw_a": _np(d.sample([8], seed=42)),
                "draw_b": _np(d.sample([8], seed=42)),
                "draw_c": _np(d.sample([8], seed=43))}
    got = _both(case)
    np.testing.assert_array_equal(got["draw_a"], got["draw_b"])
    assert not np.array_equal(got["draw_a"], got["draw_c"])


def test_stack_transform_length_mismatch():
    def case(p):
        D = p.distribution
        t = D.StackTransform([D.ExpTransform(), D.TanhTransform()])
        with pytest.raises(ValueError):
            t.forward(p.to_tensor(np.zeros((3, 2), np.float32)))
        x = p.to_tensor(np.linspace(-1, 1, 8).reshape(2, 4).astype("float32"))
        return {"y": _np(t.forward(x)), "ldj": _np(
            t.forward_log_det_jacobian(x)), "x": _np(t.inverse(t.forward(x)))}
    assert _both(case)["y"].shape == (2, 4)


KL_PAIRS = {
    "normal": lambda D, T: (D.Normal(0.0, 1.0), D.Normal(1.0, 2.0)),
    "lognormal": lambda D, T: (D.LogNormal(0.2, 0.7), D.LogNormal(-0.1, 1.3)),
    "uniform": lambda D, T: (D.Uniform(0.0, 1.0), D.Uniform(-1.0, 2.0)),
    "uniform_out": lambda D, T: (D.Uniform(-1.0, 2.0), D.Uniform(0.0, 1.0)),
    "laplace": lambda D, T: (D.Laplace(0.0, 1.0), D.Laplace(0.5, 2.0)),
    "exponential": lambda D, T: (D.Exponential(T(f32([1.5, 0.4]))),
                                 D.Exponential(T(f32([0.7, 2.0])))),
    "categorical": lambda D, T: (
        D.Categorical(T(np.log(f32([0.3, 0.7])))),
        D.Categorical(T(np.log(f32([0.5, 0.5]))))),
    "bernoulli": lambda D, T: (D.Bernoulli(T(f32([0.3, 0.9]))),
                               D.Bernoulli(T(f32([0.6, 0.2])))),
    "beta": lambda D, T: (D.Beta(2.0, 3.0), D.Beta(1.5, 0.7)),
    "dirichlet": lambda D, T: (D.Dirichlet(T(f32([1.0, 2.0]))),
                               D.Dirichlet(T(f32([2.0, 1.0])))),
    "gumbel": lambda D, T: (D.Gumbel(0.0, 1.0), D.Gumbel(1.0, 2.0)),
    "independent": lambda D, T: (
        D.Independent(D.Normal(T(np.zeros((3, 4), np.float32)),
                               T(np.ones((3, 4), np.float32))), 1),
        D.Independent(D.Normal(T(np.full((3, 4), 0.5, np.float32)),
                               T(np.full((3, 4), 2.0, np.float32))), 1)),
}


@pytest.mark.parametrize("pair", sorted(KL_PAIRS))
def test_kl_registry_pairs(pair):
    def case(p):
        return {"kl": _np(p.distribution.kl_divergence(
            *KL_PAIRS[pair](p.distribution, p.to_tensor)))}
    got = _both(case)
    if pair == "uniform_out":
        assert np.isinf(got["kl"])
    else:
        assert (got["kl"] >= -1e-6).all()


def test_kl_registry():
    def case(p):
        D, T = p.distribution, p.to_tensor
        return {"normal": _np(D.kl_divergence(D.Normal(0.0, 1.0),
                                              D.Normal(1.0, 2.0))),
                "same_beta": _np(D.kl_divergence(D.Beta(2.0, 3.0),
                                                 D.Beta(2.0, 3.0))),
                "cat": _np(D.kl_divergence(
                    D.Categorical(T(np.log(f32([0.3, 0.7])))),
                    D.Categorical(T(np.log(f32([0.5, 0.5]))))))}
    got = _both(case)
    np.testing.assert_allclose(got["normal"],
                               math.log(2.0) + 2 / 8.0 - 0.5, rtol=1e-5)
    np.testing.assert_allclose(got["same_beta"], 0.0, atol=1e-6)


def test_kl_monte_carlo_cross_check():
    def case(p):
        D = p.distribution
        pd, qd = D.Laplace(0.0, 1.0), D.Laplace(0.5, 2.0)
        s = pd.sample([200000])
        return {"draw": _np(s), "kl": _np(D.kl_divergence(pd, qd)),
                "diff": _np(pd.log_prob(s)) - _np(qd.log_prob(s))}
    got = _both(case, dict(rtol=1e-5, atol=4e-6), seed=7)
    np.testing.assert_allclose(float(got["kl"]), got["diff"].mean(),
                               atol=0.02)


def test_transforms_roundtrip_and_ldj():
    x = np.linspace(-2, 2, 9).astype(np.float32)
    cases = [("exp", lambda D: D.ExpTransform(), x),
             ("sigmoid", lambda D: D.SigmoidTransform(), x),
             ("tanh", lambda D: D.TanhTransform(), x * 0.9),
             ("affine", lambda D: D.AffineTransform(1.0, 2.5), x),
             ("power", lambda D: D.PowerTransform(2.0), np.abs(x) + 0.1),
             ("abs", lambda D: D.AbsTransform(), x),
             ("reshape", lambda D: D.ReshapeTransform([9], [3, 3]), x),
             ("independent", lambda D: D.IndependentTransform(
                 D.ExpTransform(), 1), x),
             ("chain", lambda D: D.ChainTransform(
                 [D.ExpTransform(), D.AffineTransform(0.5, 2.0)]), x)]

    def case(p):
        out = {}
        for name, make, xs in cases:
            t = make(p.distribution)
            xt = p.to_tensor(xs)
            y = t.forward(xt)
            out[f"{name}_y"] = _np(y)
            out[f"{name}_x"] = _np(t.inverse(y))
            out[f"{name}_ldj"] = _np(t.forward_log_det_jacobian(xt))
            out[f"{name}_ildj"] = _np(t.inverse_log_det_jacobian(y))
        sm = p.distribution.SoftmaxTransform()
        out["softmax_y"] = _np(sm.forward(p.to_tensor(x)))
        out["softmax_x"] = _np(sm.inverse(sm.forward(p.to_tensor(x))))
        return out
    got = _both(case, dict(rtol=2e-6, atol=2e-6))
    for name, _, xs in cases[:5]:
        np.testing.assert_allclose(got[f"{name}_x"], xs, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got[f"{name}_ildj"], -got[f"{name}_ldj"],
                                   atol=1e-4)


def test_stickbreaking_roundtrip():
    def case(p):
        t = p.distribution.StickBreakingTransform()
        x = p.to_tensor(f32([0.3, -0.2, 0.5]))
        y = t.forward(x)
        return {"y": _np(y), "x": _np(t.inverse(y)),
                "ldj": _np(t.forward_log_det_jacobian(x))}
    got = _both(case, dict(rtol=2e-6, atol=2e-6))
    np.testing.assert_allclose(got["y"].sum(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got["x"], [0.3, -0.2, 0.5], rtol=1e-4,
                               atol=1e-5)


def test_transformed_distribution_lognormal_equivalence():
    def case(p):
        D = p.distribution
        v = p.to_tensor(f32([0.5, 1.0, 2.5]))
        td = D.TransformedDistribution(D.Normal(0.3, 0.8), [D.ExpTransform()])
        ln = D.LogNormal(0.3, 0.8)
        return {"td": _np(td.log_prob(v)), "ln": _np(ln.log_prob(v)),
                "ln_mean": _np(ln.mean), "ln_var": _np(ln.variance),
                "ln_ent": _np(ln.entropy()), "draw": _np(ln.sample([50]))}
    got = _both(case, seed=17)
    np.testing.assert_allclose(got["td"], got["ln"], rtol=1e-5)


def test_independent():
    def case(p):
        D = p.distribution
        base = D.Normal(p.to_tensor(np.zeros((3, 4), np.float32)),
                        p.to_tensor(np.ones((3, 4), np.float32)))
        ind = D.Independent(base, 1)
        assert ind.batch_shape == [3] and ind.event_shape == [4]
        v = p.to_tensor(np.ones((3, 4), np.float32))
        return {"lp": _np(ind.log_prob(v)), "ent": _np(ind.entropy()),
                "kl": _np(D.kl_divergence(ind, D.Independent(base, 1)))}
    got = _both(case)
    assert got["lp"].shape == (3,)
    np.testing.assert_allclose(got["kl"], np.zeros(3), atol=1e-6)


def test_expfamily_generic_entropy_and_kl():
    def case(p):
        D = p.distribution
        d, q = D.Normal(1.0, 2.0), D.Normal(-0.5, 0.7)
        from importlib import import_module
        kl = import_module(D.__name__ + ".kl")
        return {"bregman": _np(d._entropy_bregman()), "ent": _np(d.entropy()),
                "kl_generic": _np(kl._kl_expfamily_expfamily(d, q)),
                "kl": _np(D.kl_divergence(d, q))}
    got = _both(case, dict(rtol=2e-6, atol=2e-6))
    np.testing.assert_allclose(got["bregman"], got["ent"], rtol=1e-5)
    np.testing.assert_allclose(got["kl_generic"], got["kl"], rtol=1e-5)


def test_bernoulli():
    def case(p):
        d = p.distribution.Bernoulli(p.to_tensor(f32(0.3)))
        return {"lp": _np(d.log_prob(p.to_tensor(f32(1.0)))),
                "ent": _np(d.entropy()), "mean": _np(d.mean),
                "var": _np(d.variance), "draw": _np(d.sample([20000]))}
    got = _both(case, seed=11)
    np.testing.assert_allclose(got["lp"], math.log(0.3), rtol=1e-5)
    assert abs(got["draw"].mean() - 0.3) < 0.02


def test_exponential():
    def case(p):
        d = p.distribution.Exponential(p.to_tensor(f32([0.5, 2.0])))
        v = p.to_tensor(f32([0.3, 1.7]))
        return {"lp": _np(d.log_prob(v)), "cdf": _np(d.cdf(v)),
                "ent": _np(d.entropy()), "mean": _np(d.mean),
                "var": _np(d.variance), "draw": _np(d.sample([3000]))}
    got = _both(case, seed=19)
    assert abs(got["draw"][:, 0].mean() - 2.0) < 0.15


def test_log_prob_gradients_flow_to_parameters():
    def case(p):
        loc = p.to_tensor(f32([0.2, -0.4]), stop_gradient=False)
        scale = p.to_tensor(f32([1.3, 0.6]), stop_gradient=False)
        a = p.to_tensor(f32([2.0, 0.7]), stop_gradient=False)
        D = p.distribution
        v = p.to_tensor(f32([0.9, 0.1]))
        loss = (D.Normal(loc, scale).log_prob(v).sum()
                + D.Laplace(loc, scale).entropy().sum()
                + D.Beta(a, scale).log_prob(p.to_tensor(f32([0.3, 0.6]))).sum()
                + D.kl_divergence(D.Normal(loc, scale),
                                  D.Normal(0.0, 1.0)).sum())
        loss.backward()
        return {"dloc": _np(loc.grad), "dscale": _np(scale.grad),
                "da": _np(a.grad)}
    _both(case, dict(rtol=1e-5, atol=1e-6))
