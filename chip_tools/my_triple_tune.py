"""Variants of the user kernel ``my_triple``, timed on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    PYTHONPATH=. python3 chip_tools/my_triple_tune.py \\
        [--variant NAME/UNROLL/HINTS/BLOCK/CAP ...] [--old-source FILE]

Each ``--variant`` is a copy of ``paddle_tpu_torch/utils/csrc/
my_triple.cu`` with ``kUnroll = UNROLL`` (16-byte loads a thread issues
before its first store), its loads and stores as ``HINTS``: ``none`` (the
kept plain loads and stores), ``na`` (``ld.global.nc.L1::no_allocate``
loads), ``cs`` (the streaming hints ``__ldcs``/``__stcs``) or ``ldg``
(``__ldg`` loads), registered through
``cuda_op`` with blocks of ``BLOCK`` threads and a grid of ``ceil(n /
(4 UNROLL BLOCK))`` blocks, at most ``CAP`` a streaming multiprocessor
(0: no cap). The committed source runs as ``kept`` with
``chip_smoke.triple_grid``. ``--old-source`` is an earlier
``my_triple.cu`` (for example ``git show 1b5748f:paddle_tpu_torch/utils/
csrc/my_triple.cu``) with the grid it was sized for (one float4 a thread
per pass, 8 blocks an SM). All are built at once (one ``nvcc`` each),
checked bit-equal to ``x * 3.0`` at ``[8192, 8192]`` and at a size that
is not a multiple of 4, and timed at ``[8192, 8192]`` with
``chip_smoke.time_cuda`` in turns (``torch.mul(x, 3.0)``, the old source
and the kept one first and last), beside the byte bound.
"""
from __future__ import annotations

import argparse
import re

import torch

import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.utils import ShapeDtypeStruct, cuda_op

SHAPE = (8192, 8192)
SOURCE = _build.CSRC.parents[1] / "utils" / "csrc" / "my_triple.cu"
SMS = 132


def register(name, source, grid_fn, block=256):
    return cuda_op(name, source, "my_triple",
                   out_shape_fn=lambda x: ShapeDtypeStruct(x.shape, x.dtype),
                   grid_fn=grid_fn, block=block, reference=cs.triple_plain)


# the bodies of load4 and store4 for each HINTS
HINTS = {"none": None,
         "na": ('  float4 v;\n'
                '  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, '
                '[%4];"\n      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)\n'
                '      : "l"(p));\n  return v;', "  *p = v;"),
         "cs": ("  return __ldcs(p);", "  __stcs(p, v);"),
         "ldg": ("  return __ldg(p);", "  *p = v;")}
BODY = r"(__device__ inline {}\([^)]*\) {{\n)(.*?)(\n\}})"


def variant_source(unroll: int, hints: str) -> str:
    """The committed source with ``kUnroll`` and the bodies of ``load4``
    and ``store4`` rewritten."""
    src = re.sub(r"constexpr int kUnroll = \d+;",
                 f"constexpr int kUnroll = {unroll};", SOURCE.read_text())
    if HINTS[hints] is None:
        return src
    for fn, body in zip(("float4 load4", "void store4"), HINTS[hints]):
        src = re.sub(BODY.format(fn), lambda m: m.group(1) + body
                     + m.group(3), src, count=1, flags=re.S)
    return src


def variant(spec: str):
    """(name, op) of one ``--variant``."""
    name, unroll, hints, block, cap = spec.split("/")
    unroll, block, cap = int(unroll), int(block), int(cap)

    def grid(x):
        blocks = max(1, -(-x.numel() // (4 * unroll * block)))
        return (min(blocks, SMS * cap) if cap else blocks,)

    return name, register(f"my_triple_{name}",
                          variant_source(unroll, hints), grid, block)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--old-source")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("my_triple_tune: no CUDA device")
        return 2
    print(cs.card_identity(), flush=True)
    ops = {"kept": register("my_triple_kept", SOURCE.read_text(),
                            cs.triple_grid, cs.TRIPLE_BLOCK)}
    ops.update(variant(spec) for spec in opts.variant)
    if opts.old_source:
        with open(opts.old_source) as f:
            ops["old"] = register(
                "my_triple_old", f.read(),
                lambda x: (max(1, min(-(-x.numel() // 1024), SMS * 8)),))
    _build.build((), {k: v for op in ops.values()
                      for k, v in op.build_sources.items()})
    g = torch.Generator("cuda").manual_seed(5)
    x = torch.randn(SHAPE, device="cuda", generator=g)
    odd = torch.randn(4099 * 4099, device="cuda", generator=g)[1:]
    for name, op in ops.items():
        for t in (x, odd):
            if not torch.equal(op(t), t * 3.0):
                raise AssertionError(f"my_triple {name} is not x * 3.0")
    bound = 2 * x.numel() * 4 / cs.HBM_BYTES_PER_S * 1e3
    ends = ["torch.mul"] + (["old"] if "old" in ops else []) + ["kept"]
    order = ends + [n for n in ops if n not in ends] + ends[::-1]
    for name in order:
        fn = ((lambda: torch.mul(x, 3.0)) if name == "torch.mul"
              else (lambda op=ops[name]: op(x)))
        ms = cs.time_cuda(fn)
        print(f"[time] {name}: {ms:.4f} ms ({bound / ms:.3f} of the "
              f"{bound:.4f} ms byte bound)", flush=True)
    print(cs.card_identity(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
