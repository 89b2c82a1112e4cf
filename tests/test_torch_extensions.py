"""The port's host C++ extensions and kernel plugins against the JAX
package's, on the CPU.

One C++ source (``cpp_extension.load``) and one plugin ``.so`` per ABI
version, each built once with g++ from one source (the plugin against
the port's copy of ``plugin_abi.h``, byte-equal to the JAX package's),
are loaded by both packages and run on the same seeded numpy inputs:
outputs bit-equal, the v2 kernel's custom vjp's gradients too, the
arity check and the version-mismatch error in both. The port's ops also
run inside ``to_static`` (eagerly on the CPU) and in a static program
(recorded as one op each). Tests that need g++ skip without it.
"""
import os
import shutil
import subprocess
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpaddle  # noqa: E402
from paddle_tpu.utils import cpp_extension as jcpp  # noqa: E402
from paddle_tpu.utils import plugin as jplugin  # noqa: E402
import paddle_tpu_torch as tpaddle  # noqa: E402
import paddle_tpu_torch.static as tstatic  # noqa: E402
from paddle_tpu_torch.utils import cpp_extension as tcpp  # noqa: E402
from paddle_tpu_torch.utils import plugin as tplugin  # noqa: E402
from test_plugin_abi import PLUGIN_SRC, PLUGIN_V2_SRC  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

CPP_SRC = textwrap.dedent("""
    #include <cstdint>
    #include <cmath>
    extern "C" void double_it(const float* in, float* out,
                              const int64_t* shape, int64_t ndim) {
        int64_t n = 1;
        for (int64_t i = 0; i < ndim; ++i) n *= shape[i];
        for (int64_t i = 0; i < n; ++i) out[i] = in[i] * 2.0f;
    }
    extern "C" void soft(const float* in, float* out,
                         const int64_t* shape, int64_t ndim) {
        int64_t n = 1;
        for (int64_t i = 0; i < ndim; ++i) n *= shape[i];
        for (int64_t i = 0; i < n; ++i)
            out[i] = in[i] / (1.0f + std::fabs(in[i]));
    }
""")


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch.core import device as tdevice

    saved = tdevice._CURRENT[0]
    tpaddle.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the extensions")
    return "g++"


@pytest.fixture(scope="module")
def built(gxx, tmp_path_factory):
    d = tmp_path_factory.mktemp("ext")
    (d / "ops.cc").write_text(CPP_SRC)
    header = os.path.dirname(tplugin.plugin_abi_header())
    sos = {}
    for name, src, lang in (("v1", PLUGIN_SRC, []),
                            ("v2", PLUGIN_V2_SRC, ["-x", "c"])):
        (d / f"{name}.c").write_text(src)
        sos[name] = str(d / f"{name}.so")
        subprocess.run([gxx, *lang, "-shared", "-fPIC", "-O2", f"-I{header}",
                        str(d / f"{name}.c"), "-o", sos[name]], check=True,
                       capture_output=True)
    return d, sos


def _x(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _j(t):
    return np.asarray(t._value)


def test_header_is_a_copy_of_the_jax_one():
    with open(tplugin.plugin_abi_header(), "rb") as f:
        port = f.read()
    with open(jplugin.plugin_abi_header(), "rb") as f:
        jax_ = f.read()
    assert port == jax_
    assert "paddle_tpu_torch" in tplugin.plugin_abi_header()


def test_build_directory_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("PADDLE_TORCH_EXTENSION_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    import importlib

    mod = importlib.reload(tcpp)
    try:
        d = mod.get_build_directory()
        assert d.endswith("paddle_tpu_torch_extensions")
        assert d != jcpp._DEFAULT_BUILD_DIR
    finally:
        importlib.reload(tcpp)


def test_cuda_extension_raises_as_jax():
    with pytest.raises(RuntimeError, match="cuda_op"):
        tcpp.CUDAExtension(["k.cu"])
    with pytest.raises(RuntimeError):
        jcpp.CUDAExtension(["k.cu"])


@pytest.mark.parametrize("symbol", ["double_it", "soft"])
def test_cpp_extension_matches_jax_bit_for_bit(built, symbol):
    d, _ = built
    src = str(d / "ops.cc")
    (d / "jax").mkdir(exist_ok=True)       # the JAX loader makes none
    jmod = jcpp.load("ops", [src], build_directory=str(d / "jax"))
    tmod = tcpp.load("ops", [src], build_directory=str(d / "port"))
    x = _x((3, 5), 1)
    want = _j(getattr(jmod, symbol)(jpaddle.to_tensor(x)))
    got = getattr(tmod, symbol)(tpaddle.to_tensor(x))
    assert isinstance(got, tpaddle.Tensor) and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    again = tcpp.load("ops", [src], build_directory=str(d / "port"))
    assert again._path == tmod._path            # cached by source hash


def test_cpp_op_inside_to_static_and_a_program(built):
    d, _ = built
    tmod = tcpp.load("ops", [str(d / "ops.cc")], build_directory=str(
        d / "port"))
    x = _x((2, 4), 2)
    sf = tpaddle.jit.to_static(lambda t: tmod.double_it(t) + 1.0)
    np.testing.assert_array_equal(sf(tpaddle.to_tensor(x)).numpy(),
                                  2 * x + 1.0)
    main = tstatic.Program()
    with tstatic.program_guard(main):
        xv = tstatic.data("x", [None, 4], "float32")
        out = tmod.double_it(xv) * 3.0
    assert "cpp::double_it" in [r.op_name for r in main.ops]
    (r,) = tstatic.Executor().run(main, feed={"x": x}, fetch_list=[out])
    np.testing.assert_array_equal(r, 6 * x)


def test_plugin_v1_matches_jax(built):
    _, sos = built
    jns, tns = jplugin.load_kernel_plugin(sos["v1"]), \
        tplugin.load_kernel_plugin(sos["v1"])
    a, b = _x((4,), 3), _x((4,), 4)
    np.testing.assert_array_equal(
        tns.scaled_add(tpaddle.to_tensor(a), tpaddle.to_tensor(b)).numpy(),
        _j(jns.scaled_add(jpaddle.to_tensor(a), jpaddle.to_tensor(b))))
    np.testing.assert_array_equal(
        tns.softsign_host(tpaddle.to_tensor(a)).numpy(),
        _j(jns.softsign_host(jpaddle.to_tensor(a))))
    with pytest.raises(TypeError, match="expects 2 inputs"):
        tns.scaled_add(tpaddle.to_tensor(a))


def test_plugin_version_mismatch_raises_in_both(gxx, tmp_path):
    src = tmp_path / "bad.c"
    src.write_text(PLUGIN_SRC.replace("PT_PLUGIN_ABI_VERSION, 2", "99, 2"))
    so = tmp_path / "bad.so"
    subprocess.run([gxx, "-shared", "-fPIC", f"-I{os.path.dirname(
        tplugin.plugin_abi_header())}", str(src), "-o", str(so)],
        check=True, capture_output=True)
    for mod in (tplugin, jplugin):
        with pytest.raises(RuntimeError, match="ABI"):
            mod.load_kernel_plugin(str(so))


def test_plugin_v2_kernels_match_jax(built):
    _, sos = built
    jns, tns = jplugin.load_kernel_plugin(sos["v2"]), \
        tplugin.load_kernel_plugin(sos["v2"])
    i = np.arange(12, dtype=np.int32).reshape(3, 4)
    got = tns.itranspose(tpaddle.to_tensor(i))
    np.testing.assert_array_equal(got.numpy(),
                                  _j(jns.itranspose(jpaddle.to_tensor(i))))
    assert got.dtype == torch.int32
    x = _x((5,), 5)
    tb = tns.bfnegate(tpaddle.to_tensor(x).astype("bfloat16"))
    jb = jns.bfnegate(jpaddle.to_tensor(x).astype("bfloat16"))
    np.testing.assert_array_equal(tb.astype("float32").numpy(),
                                  np.asarray(_j(jb), np.float32))
    lo, hi = tns.minmax(tpaddle.to_tensor(x))
    jlo, jhi = jns.minmax(jpaddle.to_tensor(x))
    assert float(lo) == float(_j(jlo)) and float(hi) == float(_j(jhi))


def test_plugin_v2_custom_vjp_matches_jax(built):
    _, sos = built
    jns, tns = jplugin.load_kernel_plugin(sos["v2"]), \
        tplugin.load_kernel_plugin(sos["v2"])
    x = _x((6,), 6)
    tx = tpaddle.to_tensor(x, stop_gradient=False)
    jx = jpaddle.to_tensor(x)
    jx.stop_gradient = False
    tout = tns.axpb(tx, a=3.0, b=1.0)
    jout = jns.axpb(jx, a=3.0, b=1.0)
    np.testing.assert_array_equal(tout.detach().numpy(), _j(jout))
    (tout * tout).sum().backward()
    (jout * jout).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), _j(jx.grad))


def test_plugin_kernel_in_a_program(built):
    _, sos = built
    tns = tplugin.load_kernel_plugin(sos["v2"])
    main = tstatic.Program()
    with tstatic.program_guard(main):
        xv = tstatic.data("x", [None, 3], "float32")
        out = tns.axpb(xv, a=2.0, b=0.5)
    assert "plugin::axpb" in [r.op_name for r in main.ops]
    x = _x((4, 3), 7)
    (r,) = tstatic.Executor().run(main, feed={"x": x}, fetch_list=[out])
    np.testing.assert_array_equal(r, np.float32(2.0) * x + np.float32(0.5))
