"""Variants of the ragged paged-attention kernels, timed on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    PYTHONPATH=. python3 chip_tools/ragged_tune.py \\
        [--variant NAME/KEY=VALUE/...] [--old-source FILE] \\
        [--parent-decode FILE] [--modes f32,int8,fp8]

Each ``--variant`` is a copy of ``paddle_tpu_torch/kernels/csrc/
ragged_attention.cuh`` with some of its shapes rewritten:

- ``ctile=WARPS, MT, BK, NS`` and ``ftile=...``: the head_dim-64 tile's
  launch line for code pages and for float32 pages (warps a block, 16-row
  tiles a warp, keys a walked tile, ring stages);
- ``dq=N``: ``kDecodeMaxQ`` (rows of up to N queries take the decode
  walk, longer ones the tile; the walk it shares with the decode kernel,
  ``paged_walk.cuh``, takes one query, so N > 1 no longer builds);
- ``dw=N``: ``kDecodeWarps`` (the decode walk's most warps a block);
- ``dpw=N``: ``kDecodePagesPerWarp`` (a warp for every N pages a block
  walks);
- ``dns=N``: ``kDecodeStages`` (the decode walk's ring: pages a warp
  holds, in flight and being read).

For example ``--variant "bk32/ctile=4, 1, 32, 2" --variant "dq4/dq=4"``.
Every variant is built for each page type of ``--modes`` (one ``nvcc``
per library, all at once, into ``paddle_tpu_torch/kernels/build/
ragged_variants/``), beside ``--old-source``, an earlier
``ragged_attention.cuh`` (for example ``git show 73a9031:paddle_tpu_torch/
kernels/csrc/ragged_attention.cuh``, the SIMT page walk; the chip
machine's copy of the repository has no ``.git``: extract it before the
call), and ``--parent-decode``, an earlier ``paged_attention.cu`` whose
decode kernel must give the port's bits.

Each build is held to the plain version at ``chip_smoke.py``'s shapes
(decode and mix at GPT-3 XL geometry, split 0 and 16; the float32 kernel
also at GPT-2-small): within 2e-5, padding exact 0, the split within
2e-5 of the unsplit kernel, a rerun bit-identical. Then each shape is
timed with ``chip_smoke.time_cuda`` in the order old, default, every
variant, default, old.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import time

import torch

import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as pa

HEADER = "ragged_attention.cuh"
TILE = r"launch_tile<T, 64, [^>]*>(?=\(a, B, max_q_len, s\);  // {})"
CTILE = re.compile(TILE.format("codes"))
FTILE = re.compile(TILE.format("float32"))
DQ = re.compile(r"constexpr int kDecodeMaxQ = \d+;")
DW = re.compile(r"constexpr int kDecodeWarps = \d+;")
DPW = re.compile(r"constexpr int kDecodePagesPerWarp = \d+;")
DNS = re.compile(r"constexpr int kDecodeStages = \d+;")
MODES = {"f32": ("ragged_attention", "ragged_attention_f32"),
         "int8": ("ragged_attention_int8", "ragged_attention_int8"),
         "fp8": ("ragged_attention_fp8", "ragged_attention_fp8")}
ENTRY = pa._entry                  # the port's own library lookup


def variant_header(spec: str):
    """(name, header source) of one ``--variant``."""
    name, *assigns = spec.split("/")
    src = (_build.CSRC / HEADER).read_text()
    for assign in assigns:
        key, value = (x.strip() for x in assign.split("=", 1))
        if key in ("ctile", "ftile"):
            pattern = CTILE if key == "ctile" else FTILE
            src = pattern.sub(f"launch_tile<T, 64, {value}>", src)
        elif key == "dq":
            src = DQ.sub(f"constexpr int kDecodeMaxQ = {int(value)};", src)
        elif key == "dw":
            src = DW.sub(f"constexpr int kDecodeWarps = {int(value)};", src)
        elif key == "dpw":
            src = DPW.sub(f"constexpr int kDecodePagesPerWarp = {int(value)};",
                          src)
        elif key == "dns":
            src = DNS.sub(f"constexpr int kDecodeStages = {int(value)};", src)
        else:
            raise ValueError(f"unknown variant key {key!r} in {spec!r}")
    return name, src


def build_all(specs, old_source, parent_decode, modes):
    """Compile every variant's and the old header's libraries of
    ``modes``, and the parent's decode kernel, at once: {(name, mode):
    library} and {"parent_decode": library}. ``#include "..."`` finds
    the port's other headers through ``-I``."""
    root = _build.BUILD_DIR / "ragged_variants"
    headers = dict(variant_header(s) for s in specs)
    if old_source:
        with open(old_source) as f:
            headers["old"] = f.read()
    jobs = {}
    for name, text in headers.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / HEADER).write_text(text)
        for mode in modes:
            lib = MODES[mode][0]
            (d / f"{lib}.cu").write_text((_build.CSRC / f"{lib}.cu")
                                         .read_text())
            jobs[(name, mode)] = (d / f"{lib}.cu", d / f"{lib}.so")
    if parent_decode:
        root.mkdir(parents=True, exist_ok=True)
        jobs[("parent_decode", None)] = (parent_decode,
                                         root / "parent_decode.so")
    t0 = time.perf_counter()
    procs = {key: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for key, (src, out) in jobs.items()}
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {key}: registers {regs}, spill stores {spills}",
              flush=True)
        libs[key] = ctypes.CDLL(str(jobs[key][1]))
    print(f"[build] {len(jobs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return libs


def rows_only(args, tile_rows: bool):
    """``args`` with the rows of the other kind idle (q_len 0): only the
    tile rows (more than one query) or only the one-query rows."""
    q_lens = args["q_lens"]
    keep = q_lens > 1 if tile_rows else q_lens == 1
    return dict(args, q_lens=torch.where(keep, q_lens, 0))


def cases(modes, device):
    """(label, args, scales, max_q, n_used, split, mode) at the smoke's
    shapes; the GPT-3 XL mix also with its tile rows alone and its
    one-query rows alone (where its time goes)."""
    out = []
    for mode in modes:
        geoms = [(cs.GPT3_XL, "")] + ([(cs.GPT2_SMALL, " gpt2_small")]
                                      if mode == "f32" else [])
        for spec, suffix in geoms:
            for kind, seed in (("decode", 1), ("mix", 0)):
                args, scales, max_q, n_used = cs.ragged_mix(
                    kind, seed, device, spec, mode)
                parts = [(kind, args, max_q)]
                if kind == "mix" and spec is cs.GPT3_XL:
                    parts += [("mix tiles", rows_only(args, True), max_q),
                              ("mix decode rows", rows_only(args, False), 1)]
                for split in ((0, cs.SPLIT) if spec is cs.GPT3_XL else (0,)):
                    for name, part, mq in parts:
                        out.append((f"{mode} {name}{suffix} split {split}",
                                    part, scales, mq, n_used, split, mode))
    return out


def run(args, scales, max_q, split):
    return pa.ragged_attention(**args, tier="kernel", max_q_len=max_q,
                               split_pages=split, **scales)


def check(name, pick, all_cases) -> None:
    """One build against the plain version at every case."""
    worst = 0.0
    try:
        pa._entry = pick
        unsplit = {}
        for label, args, scales, max_q, n_used, split, _ in all_cases:
            out = run(args, scales, max_q, split)
            again = run(args, scales, max_q, split)
            torch.cuda.synchronize()
            ref = cs.plain(args, scales, split)
            worst = max(worst, (out - ref).abs().max().item())
            torch.testing.assert_close(out, ref, rtol=cs.ATTN_TOL,
                                       atol=cs.ATTN_TOL, msg=label)
            if not torch.equal(out, again):
                raise AssertionError(f"{name} {label}: a rerun differs")
            if n_used < len(out) and out[n_used:].abs().max().item() != 0:
                raise AssertionError(f"{name} {label}: padding not 0")
            key = label.rsplit(" split", 1)[0]
            if split == 0:
                unsplit[key] = out
            else:
                torch.testing.assert_close(out, unsplit[key],
                                           rtol=cs.ATTN_TOL,
                                           atol=cs.ATTN_TOL, msg=label)
    finally:
        pa._entry = ENTRY
    print(f"[check] {name}: {len(all_cases)} cases within 2e-5 of the plain "
          f"version (worst {worst:.3e}), padding 0, split vs unsplit within "
          "2e-5, reruns bit-identical", flush=True)


def check_decode_bits(parent, device) -> None:
    """The port's decode kernel (``paged_attention.cu``) against the
    parent's build: the same bits at its smoke shape."""
    args = cs.per_tier_mix("decode", 40, device)
    got = cs.per_tier_call(args, "kernel")
    fn = parent.paged_attention_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    try:
        pa._entry = lambda lib_name, entry, n_ptr, n_int: fn
        want = cs.per_tier_call(args, "kernel")
    finally:
        pa._entry = ENTRY
    if not torch.equal(got, want):
        raise AssertionError("the decode kernel's bits moved")
    print("[check] paged_attention (decode) bit-identical to the parent's "
          "build", flush=True)


def time_all(picks, all_cases) -> None:
    names = [n for n in picks if n not in ("default", "old")]
    old = ["old"] if "old" in picks else []
    order = old + ["default"] + names + ["default"] + old
    for label, args, scales, max_q, _, split, mode in all_cases:
        bound_ms, by = cs.bound(args, mode != "f32")
        times = []
        try:
            for name in order:
                pa._entry = picks[name]
                ms = cs.time_cuda(lambda: run(args, scales, max_q, split))
                times.append(f"{name} {ms:.4f}")
        finally:
            pa._entry = ENTRY
        print(f"[time] {label}: " + ", ".join(times)
              + f" ms; bound {bound_ms:.4f} ({by})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--old-source")
    ap.add_argument("--parent-decode")
    ap.add_argument("--modes", default="f32,int8,fp8")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("ragged_tune: no CUDA device")
        return 2
    modes = opts.modes.split(",")
    device = torch.device("cuda")
    print(cs.card_identity(), flush=True)
    _build.build([MODES[m][0] for m in modes] + ["paged_attention"])
    libs = build_all(opts.variant, opts.old_source, opts.parent_decode, modes)
    all_cases = cases(modes, device)
    picks = {"default": ENTRY}
    names = {name for name, _ in libs if name != "parent_decode"}
    for name in sorted(names, key=lambda n: n == "old"):
        picks[name] = cs.ragged_entry({MODES[m][1]: libs[(name, m)]
                                       for m in modes})
    for name, pick in picks.items():
        check(name, pick, all_cases)
    if ("parent_decode", None) in libs:
        check_decode_bits(libs[("parent_decode", None)], device)
    time_all(picks, all_cases)
    print(cs.card_identity(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
