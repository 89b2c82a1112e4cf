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
    assert {"flash_attention", "flash_bwd_f32", "paged_attention",
            "mixed_attention"} <= set(_build.KERNELS)
    ragged = _build.CSRC / "ragged_attention.cuh"
    walk = _build.CSRC / "paged_walk.cuh"
    cp_async = _build.CSRC / "cp_async.cuh"
    tf32x3 = _build.CSRC / "tf32x3.cuh"
    want = {"flash_attention": [], "flash_fwd_bf16": [cp_async],
            "flash_bwd_bf16": [cp_async],
            "flash_bwd_f32": [cp_async, tf32x3],
            "paged_attention": [walk],
            "mixed_attention": [walk, cp_async]}
    for name in _build.KERNELS:
        headers = _build._local_headers(_build.CSRC / f"{name}.cu")
        assert headers == want.get(name, [ragged, walk])


def test_tune_tool_rewrites_each_variant():
    """``chip_tools/flash_bwd_f32_tune.py`` builds variants of the float32
    backward by rewriting its head_dim-64 launch lines and the split
    routine of ``tf32x3.cuh``: both patterns still match the sources."""
    import importlib.util
    import re

    path = _build.CSRC.parents[2] / "chip_tools" / "flash_bwd_f32_tune.py"
    spec = importlib.util.spec_from_file_location("flash_bwd_f32_tune", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    launches = r"launch_d\w+<64, [^>]*>"
    kept = re.findall(launches, (_build.CSRC / "flash_bwd_f32.cu").read_text())
    assert len(kept) == 2
    for split in tool.SPLITS:
        name, src, header = tool.variant_sources(f"v/8, 1, 16/4, 2, 64/{split}")
        assert re.findall(launches, src) == ["launch_dkdv<64, 8, 1, 16>",
                                             "launch_dq<64, 4, 2, 64>"]
        body = tool.SPLIT_BODY.search(header).group(2)
        assert ("cvt.rna" in body) == (split == "cvt")
        assert ("+ 0x1000u;" in body) == (split == "round")
