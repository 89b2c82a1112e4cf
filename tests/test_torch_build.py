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
    """Each library of ``KERNELS`` has its source, includes exactly its
    headers, and every ``.cu`` of ``csrc/`` is a library: the float32
    forward is ``flash_fwd_f32`` (no ``flash_attention`` library is
    left), on the tile helpers it shares with the float32 backward; the
    ragged libraries' tensor-core tile uses the same helpers, and the
    decode kernel and the ragged libraries' one-query rows share the page
    walk (the mixed kernel takes its launch helpers); the narrow-scale
    ragged libraries include the ragged header like the others, the
    int8 matmul and the dropout kernel include no header, and the bf16
    and float16 flash libraries build the same 16-bit sources."""
    assert {"flash_fwd_f32", "flash_bwd_f32", "paged_attention",
            "mixed_attention"} <= set(_build.KERNELS)
    assert "flash_attention" not in _build.KERNELS
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(
        _build.KERNELS)
    ragged = _build.CSRC / "ragged_attention.cuh"
    walk = _build.CSRC / "paged_walk.cuh"
    cp_async = _build.CSRC / "cp_async.cuh"
    tf32x3 = _build.CSRC / "tf32x3.cuh"
    tiles = _build.CSRC / "flash_f32_tiles.cuh"
    fwd16 = _build.CSRC / "flash_fwd_16.cuh"
    bwd16 = _build.CSRC / "flash_bwd_16.cuh"
    elem16 = _build.CSRC / "flash_elem16.cuh"
    want = {"flash_fwd_f32": [tiles, cp_async, tf32x3],
            "flash_fwd_bf16": [fwd16, cp_async, elem16],
            "flash_fwd_f16": [fwd16, cp_async, elem16],
            "flash_bwd_bf16": [bwd16, cp_async, elem16],
            "flash_bwd_f16": [bwd16, cp_async, elem16], "dropout": [],
            "flash_bwd_f32": [tiles, cp_async, tf32x3],
            "paged_attention": [walk, cp_async],
            "mixed_attention": [walk, cp_async],
            "int8_matmul": []}
    for name in _build.KERNELS:
        headers = _build._local_headers(_build.CSRC / f"{name}.cu")
        assert headers == want.get(name, [ragged, walk, cp_async, tiles,
                                          tf32x3])


def _tool(name):
    import importlib

    return importlib.import_module(f"chip_tools.{name}")


def test_tune_tool_rewrites_each_variant():
    """``chip_tools/flash_bwd_f32_tune.py`` builds variants of the float32
    backward by rewriting its head_dim-64 launch lines and the split
    routine of ``tf32x3.cuh``: both patterns still match the sources."""
    import re

    tool = _tool("flash_bwd_f32_tune")
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


def test_forward_tune_tool_rewrites_each_variant():
    """``chip_tools/flash_fwd_f32_tune.py`` builds variants of the float32
    forward by rewriting its one head_dim-64 launch line, and checks more
    edge lengths than the backward's tool (head_dim 128 among them)."""
    tool = _tool("flash_fwd_f32_tune")
    src = (_build.CSRC / "flash_fwd_f32.cu").read_text()
    assert len(tool.LAUNCH.findall(src)) == 1
    name, variant = tool.variant_source("v/4, 2, 64")
    assert name == "v"
    assert tool.LAUNCH.findall(variant) == ["launch<64, 4, 2, 64>"]
    assert variant.replace("launch<64, 4, 2, 64>", "") == tool.LAUNCH.sub(
        "", src)
    assert {D for _, _, D, _ in tool.EDGES} == {64, 128}


def test_my_triple_tool_rewrites_each_variant():
    """``chip_tools/my_triple_tune.py`` builds variants of the user kernel
    by rewriting ``kUnroll`` and the bodies of ``load4`` and ``store4``:
    the patterns still match the source, the kept hints leave it as it
    is, and every variant still declares ``cuda_op``'s launch contract."""
    import importlib

    import torch

    custom_op = importlib.import_module("paddle_tpu_torch.utils.custom_op")
    tool = _tool("my_triple_tune")
    src = tool.SOURCE.read_text()
    assert tool.variant_source(2, "none") == src
    for hints, (load, store) in ((h, b) for h, b in tool.HINTS.items() if b):
        variant = tool.variant_source(8, hints)
        assert "constexpr int kUnroll = 8;" in variant
        assert load in variant and store in variant
        assert custom_op.kernel_pointer_dtypes(variant, "my_triple") == [
            torch.float32, torch.float32]


def test_ragged_tool_rewrites_each_variant():
    """``chip_tools/ragged_tune.py`` builds variants of the ragged kernels
    by rewriting the head_dim-64 tile's launch lines (code and float32
    pages) and the decode walk's constants in ``ragged_attention.cuh``:
    each pattern matches once, and a variant differs from the header
    only there."""
    tool = _tool("ragged_tune")
    src = (_build.CSRC / tool.HEADER).read_text()
    patterns = (tool.CTILE, tool.FTILE, tool.DQ, tool.DW, tool.DPW, tool.DNS)
    for pattern in patterns:
        assert len(pattern.findall(src)) == 1, pattern.pattern
    name, variant = tool.variant_header(
        "v/ctile=4, 2, 64, 3/ftile=2, 1, 32, 2/dq=2/dw=4/dpw=2/dns=3")
    assert name == "v"
    assert tool.CTILE.findall(variant) == ["launch_tile<T, 64, 4, 2, 64, 3>"]
    assert tool.FTILE.findall(variant) == ["launch_tile<T, 64, 2, 1, 32, 2>"]
    assert "constexpr int kDecodeMaxQ = 2;" in variant
    assert "constexpr int kDecodeWarps = 4;" in variant
    assert "constexpr int kDecodePagesPerWarp = 2;" in variant
    assert "constexpr int kDecodeStages = 3;" in variant

    def strip(text):
        for pattern in patterns:
            text = pattern.sub("", text)
        return text
    assert strip(variant) == strip(src)
    assert tool.variant_header("same")[1] == src


def test_decode_tool_rewrites_each_variant():
    """``chip_tools/decode_tune.py`` builds variants of the decode kernel
    by rewriting its launch constants in ``paged_attention.cu``: each
    pattern matches once, and a variant differs from the source only
    there."""
    tool = _tool("decode_tune")
    src = (_build.CSRC / tool.SOURCE).read_text()
    for pattern in tool.PATTERNS.values():
        assert len(pattern.findall(src)) == 1, pattern.pattern
    name, variant = tool.variant_source("v/warps=8/ppw=1/cluster=2/ns=3")
    assert name == "v"
    for line in ("kWarps = 8;", "kPagesPerWarp = 1;", "kMaxCluster = 2;",
                 "kStages = 3;"):
        assert f"constexpr int {line}" in variant

    def strip(text):
        for pattern in tool.PATTERNS.values():
            text = pattern.sub("", text)
        return text
    assert strip(variant) == strip(src)
    assert tool.variant_source("same")[1] == src
