"""The kernel build's cache key: a library's file name carries a digest
of its source, the ``csrc/`` headers it includes (directly or through
another header) and the flags, so an edit rebuilds exactly the
libraries it touches. Runs on the CPU: nothing is compiled."""
import pytest

pytest.importorskip("torch")

from paddle_tpu_torch.kernels import _build  # noqa: E402


def test_digest_covers_the_included_headers_only(tmp_path, monkeypatch):
    (tmp_path / "a.cuh").write_text("// a\n")
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\n')
    (tmp_path / "x.cu").write_text('#include "b.cuh"\n'
                                   "#include <cuda_runtime.h>\n")
    (tmp_path / "y.cu").write_text("#include <cuda_runtime.h>\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._local_headers(tmp_path / "x.cu") == [tmp_path / "b.cuh",
                                                        tmp_path / "a.cuh"]
    x0, y0 = _build.library_path("x"), _build.library_path("y")
    (tmp_path / "a.cuh").write_text("// a, edited\n")
    assert _build.library_path("x") != x0
    assert _build.library_path("y") == y0
    (tmp_path / "y.cu").write_text("// edited\n")
    assert _build.library_path("y") != y0


def test_the_port_libraries_and_their_headers():
    assert {"flash_attention", "paged_attention",
            "mixed_attention"} <= set(_build.KERNELS)
    ragged = _build.CSRC / "ragged_attention.cuh"
    walk = _build.CSRC / "paged_walk.cuh"
    cp_async = _build.CSRC / "cp_async.cuh"
    want = {"flash_attention": [], "flash_fwd_bf16": [cp_async],
            "flash_bwd_bf16": [cp_async],
            "paged_attention": [walk],
            "mixed_attention": [walk, cp_async]}
    for name in _build.KERNELS:
        headers = _build._local_headers(_build.CSRC / f"{name}.cu")
        assert headers == want.get(name, [ragged, walk])
