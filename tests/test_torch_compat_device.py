"""``compat``, ``device``, ``reader``, ``strings``, ``sysconfig``,
``hub``, ``utils`` and ``autograd`` of the port against the JAX
package, on the CPU.

Each case runs the same call through ``paddle_tpu`` and
``paddle_tpu_torch`` and compares what comes back: places (``CUDAPlace``
and ``TPUPlace`` name the card, as the JAX package's name its
accelerator; here, with no card, ``set_device`` of one raises), dtype
queries, ``iinfo``, ``batch`` and the reader combinators (equal
outputs), string tensors, the local ``hub`` over a ``hubconf.py`` in a
temporary directory, ``utils``' helpers (``run_check`` on the CPU) and
``autograd``'s ``PyLayerMeta`` / ``saved_tensors_hooks`` (the hooks
run on the saved tensors; the gradient equals the JAX package's).
``device.cuda`` is ``tests/test_amp_debugging.py``'s namespace case on
the port: without a card its counters read 0 and its streams and
events do nothing. Values are compared exactly (float32 within 1e-6).
"""
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.core.device as jcore  # noqa: E402
import paddle_tpu.device as jdevice  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch import device as tdev  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


# ----------------------------------------------------------- places --


def test_places_match_jax():
    for name in ("CUDAPlace", "NPUPlace"):
        j, t = getattr(jp, name)(1), getattr(tp, name)(1)
        assert isinstance(t, tp.Place) and t.index == j.index == 1
    assert repr(tp.CPUPlace()) == repr(jp.CPUPlace()) == "Place(cpu:0)"
    assert tp.CPUPlace(0) == tp.CPUPlace(0) != tp.CUDAPlace(0)
    assert tp.TPUPlace(1) == tp.CUDAPlace(1) == tp.Place("gpu", 1)
    assert tp.CUDAPlace(0).is_gpu_place() and tp.TPUPlace().is_tpu_place()
    assert tp.CPUPlace().is_cpu_place() and jp.CPUPlace().is_cpu_place()
    assert tp.CUDAPinnedPlace().platform == jp.CUDAPinnedPlace().platform
    assert tp.is_compiled_with_tpu() == torch.cuda.is_available()
    assert tp.is_compiled_with_tpu() == jp.is_compiled_with_tpu() is False


def test_set_device_takes_places():
    assert tp.set_device(tp.CPUPlace()) == torch.device("cpu")
    assert tp.get_device() == "cpu"
    if torch.cuda.is_available():
        assert tdevice.to_torch_device(tp.TPUPlace(0)) == \
            torch.device("cuda:0")
    else:
        for place in (tp.CUDAPlace(0), tp.TPUPlace(0), "tpu", "gpu:0"):
            with pytest.raises(RuntimeError, match="CUDA"):
                tp.set_device(place)
    assert tp.device.current_place() == tp.CPUPlace()


@pytest.mark.parametrize("place", ["CUDAPinnedPlace", "NPUPlace"])
def test_places_without_a_device_raise(place):
    """Pinned host memory and an NPU name no device of the port; the JAX
    package's ``jax_device`` raises for them too."""
    with pytest.raises(RuntimeError, match="Unknown backend"):
        jcore.jax_device(getattr(jp, place)())
    with pytest.raises(RuntimeError, match="no device"):
        tp.set_device(getattr(tp, place)())
    assert tp.get_device() == "cpu"


def test_dtype_queries_and_iinfo_match_jax():
    cases = [np.zeros(3, "float32"), np.zeros(3, "int32"),
             np.zeros(3, "bool"), np.zeros(3, "complex64"),
             np.zeros(3, "int64")]
    for a in cases:
        for q in ("is_complex", "is_floating_point", "is_integer"):
            assert getattr(tp, q)(tp.to_tensor(a)) == \
                getattr(jp, q)(jp.to_tensor(a)), (q, a.dtype)
    for name in ("int8", "int16", "int32", "uint8"):
        t, j = tp.iinfo(name), jp.iinfo(name)
        assert (t.min, t.max, t.bits) == (j.min, j.max, j.bits)
    assert tp.dtype("float16") == torch.float16
    assert str(jp.dtype("float16")) == "float16"
    for ok in ([2, 3], [-1, 4], [None, 2]):
        tp.check_shape(ok)
        jp.check_shape(ok)
    for p in (tp, jp):
        with pytest.raises(ValueError):
            p.check_shape([2, -3])
        p.disable_signal_handler()
        with p.LazyGuard():
            pass


def test_batch_matches_jax():
    rd = lambda: iter(range(7))  # noqa: E731
    for drop in (False, True):
        assert list(tp.batch(rd, 3, drop)()) == list(jp.batch(rd, 3, drop)())


def test_data_parallel_is_the_layer():
    x = np.random.default_rng(0).standard_normal((3, 4)).astype("float32")
    j = jp.nn.Linear(4, 2)
    t = tp.nn.Linear(4, 2)
    t.set_state_dict({k: np.asarray(v.numpy())
                      for k, v in j.state_dict().items()})
    jd, td = jp.DataParallel(j), tp.DataParallel(t)
    assert sorted(td.state_dict()) == sorted(jd.state_dict())
    np.testing.assert_allclose(td(tp.to_tensor(x)).detach().numpy(),
                               jd(jp.to_tensor(x)).numpy(), rtol=1e-6,
                               atol=1e-6)
    loss = tp.to_tensor(2.0)
    assert td.scale_loss(loss) is loss


def test_rng_state_and_print_options():
    assert tp.get_cuda_rng_state() == [] or torch.cuda.is_available()
    tp.set_cuda_rng_state(tp.get_cuda_rng_state())
    saved = torch._tensor_str.PRINT_OPTS.precision
    try:
        tp.set_printoptions(precision=2)
        assert "3.14" in repr(tp.to_tensor([3.14159]))
        assert "3.142" not in repr(tp.to_tensor([3.14159]))
    finally:
        torch.set_printoptions(precision=saved)


def test_create_parameter_and_param_attr_at_the_top():
    w = tp.create_parameter([2, 3], "float32",
                            default_initializer=tp.nn.initializer.Constant(
                                1.5))
    j = jp.create_parameter([2, 3], "float32",
                            default_initializer=jp.nn.initializer.Constant(
                                1.5))
    np.testing.assert_array_equal(w.detach().numpy(), j.numpy())
    assert not w.stop_gradient and not j.stop_gradient
    assert tp.ParamAttr is tp.nn.ParamAttr


# ----------------------------------------------------------- device --


def test_device_cuda_namespace():
    d = tp.device
    assert d.cuda.device_count() >= 0
    assert isinstance(d.cuda.get_device_name(), str)
    assert d.cuda.memory_allocated() >= 0
    assert d.cuda.max_memory_reserved() >= 0
    d.cuda.synchronize()
    d.cuda.empty_cache()
    with d.cuda.stream_guard(d.cuda.current_stream()):
        pass
    if not torch.cuda.is_available():
        for name in ("memory_allocated", "memory_reserved",
                     "max_memory_allocated", "max_memory_reserved"):
            assert getattr(d.cuda, name)() == getattr(jdevice.cuda, name)()
        assert d.cuda.get_device_name() == jdevice.cuda.get_device_name()
        assert d.cuda.device_count() == jdevice.cuda.device_count() == 0
        assert d.cuda.get_device_properties() is None


def test_streams_and_events_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the stand-ins are what a machine without CUDA gets")
    s = tdev.Stream(priority=1)
    e = s.record_event()
    assert e.query() and s.query()
    s.wait_event(e)
    s.wait_stream(tdev.current_stream())
    s.synchronize()
    e.synchronize()
    with pytest.raises(RuntimeError, match="CUDA"):
        e.elapsed_time(tdev.Event())
    tdev.synchronize()


def test_device_queries_match_jax_where_both_mean_the_same():
    for name in ("is_compiled_with_rocm", "is_compiled_with_xpu",
                 "is_compiled_with_npu", "is_compiled_with_mlu",
                 "is_compiled_with_ipu"):
        assert getattr(tdev, name)() == getattr(jdevice, name)() is False
    # the port's backend is CUDA: present exactly when a card is
    assert tdev.is_compiled_with_cuda() == torch.cuda.is_available()
    assert tdev.get_all_custom_device_type() == \
        jdevice.get_all_custom_device_type() == []
    assert tdev.get_available_custom_device() == []
    assert tdev.get_all_device_type() == jdevice.get_all_device_type()
    assert tdev.get_available_device() == tp.get_device() == "cpu"
    for name in ("XPUPlace", "NPUPlace", "MLUPlace", "IPUPlace"):
        for mod in (tdev, jdevice):
            with pytest.raises(RuntimeError):
                getattr(mod, name)(0)
    assert tdev.resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------- reader, strings, sysconfig --


def test_reader_combinators_match_jax():
    import paddle_tpu.reader as JR

    R = tp.reader
    rd = lambda: iter(range(7))  # noqa: E731
    rd2 = lambda: iter([(i, -i) for i in range(7)])  # noqa: E731
    for name, args in (("firstn", (rd, 2)), ("chain", (rd, rd)),
                       ("map_readers", (lambda a, b: a + b, rd, rd)),
                       ("cache", (rd,)), ("compose", (rd, rd2)),
                       ("multiprocess_reader", ([rd, rd],))):
        assert list(getattr(R, name)(*args)()) == \
            list(getattr(JR, name)(*args)()), name
    assert sorted(R.buffered(rd, 2)()) == sorted(JR.buffered(rd, 2)())
    assert sorted(R.shuffle(rd, 3)()) == list(range(7))
    assert list(R.xmap_readers(lambda v: v * 2, rd, 2, 4)()) == \
        list(JR.xmap_readers(lambda v: v * 2, rd, 2, 4)())


def test_strings_match_jax():
    data = [["Hello", "WÖRLD"], ["mIxEd", "ÀB"]]
    for op in ("lower", "upper"):
        for utf8 in (True, False):
            t = getattr(tp.strings, op)(tp.strings.to_string_tensor(data),
                                        use_utf8_encoding=utf8)
            j = getattr(jp.strings, op)(jp.strings.to_string_tensor(data),
                                        use_utf8_encoding=utf8)
            assert t.tolist() == j.tolist()
    e = tp.strings.empty([2, 3])
    assert e.shape == jp.strings.empty([2, 3]).shape == [2, 3]
    assert e.tolist() == jp.strings.empty([2, 3]).tolist()
    c = tp.strings.copy(tp.strings.to_string_tensor(data))
    assert c == data and c.dtype == "pstring"


def test_sysconfig_paths_exist():
    assert os.path.exists(os.path.join(tp.sysconfig.get_include(),
                                       "plugin_abi.h"))
    assert os.path.isdir(tp.sysconfig.get_lib())


# --------------------------------------------------------------- hub --


HUBCONF = '''
dependencies = ["numpy"]


def tiny(scale=1.0):
    """A scaled identity."""
    return ("tiny", scale)


def _hidden():
    return None
'''


def test_hub_local_matches_jax(tmp_path):
    (tmp_path / "hubconf.py").write_text(HUBCONF)
    repo = str(tmp_path)
    assert sorted(tp.hub.list(repo)) == sorted(jp.hub.list(repo))
    assert tp.hub.help(repo, "tiny") == jp.hub.help(repo, "tiny")
    assert tp.hub.load(repo, "tiny", scale=2.0) == \
        jp.hub.load(repo, "tiny", scale=2.0)
    for p in (tp, jp):
        with pytest.raises(RuntimeError):
            p.hub.load(repo, "tiny", source="github")
        with pytest.raises(ValueError):
            p.hub.load(repo, "nope")
    (tmp_path / "hubconf.py").write_text('dependencies = ["no_such_mod"]\n')
    for p in (tp, jp):
        with pytest.raises(RuntimeError, match="no_such_mod"):
            p.hub.list(repo)


# ----------------------------------------------------- utils, autograd --


def test_utils_helpers_match_jax(capsys):
    for p in (tp, jp):
        @p.utils.deprecated(update_to="new_fn", since="2.0")
        def old(x):
            return x + 1

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert old(1) == 2
        assert "deprecated" in str(w[0].message)

        @p.utils.deprecated(level=1)
        def gone():
            return 0

        with pytest.raises(RuntimeError):
            gone()
        assert p.utils.require_version("0.0.1") is True
        with pytest.raises(RuntimeError):
            p.utils.require_version("99.0")
        assert p.utils.try_import("math").sqrt(4.0) == 2.0
        with pytest.raises(ImportError):
            p.utils.try_import("no_such_module_here")
    assert tp.__version__ == jp.__version__
    assert tp.utils.run_check() == "cpu"
    assert "installed successfully" in capsys.readouterr().out


def test_autograd_names_match_jax():
    assert isinstance(tp.autograd.PyLayer, tp.autograd.PyLayerMeta)
    assert isinstance(jp.autograd.PyLayer, jp.autograd.PyLayerMeta)
    x = np.array([0.5, -1.0, 2.0], "float32")
    grads, packed = [], []
    for p in (tp, jp):
        t = p.to_tensor(x, stop_gradient=False)

        def pack(v):
            packed.append(p)
            return v

        with p.autograd.saved_tensors_hooks(pack, lambda v: v):
            y = (t * t * t).sum()
        y.backward()
        grads.append(np.asarray(t.grad.numpy()))
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-6, atol=1e-6)
    assert tp in packed         # torch saves tensors through the hooks
