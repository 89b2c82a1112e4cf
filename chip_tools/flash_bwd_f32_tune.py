"""Variants of the float32 flash backward, timed on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    PYTHONPATH=. python3 chip_tools/flash_bwd_f32_tune.py \\
        [--variant NAME/DKDV/DQ/SPLIT ...] [--old-source FILE] [--train-ab]

Each ``--variant`` is a copy of ``paddle_tpu_torch/kernels/csrc/
flash_bwd_f32.cu`` whose head_dim-64 launch lines take ``DKDV`` = "WARPS,
MT, BQ" (warps a block, 16-key row tiles a warp, queries a walked tile)
and ``DQ`` = "WARPS, MT, BK" (warps, 16-row tiles a warp, keys a walked
tile), built against a copy of ``tf32x3.cuh`` whose ``split`` is
``SPLIT``: ``mask`` (the kept one: big rounded by an add and a mask, the
exact rest truncated by the tensor core), ``cvt`` (``cvt.rna.tf32.f32``
on both halves) or ``round`` (the rest rounded to tf32 too). Every build
goes to ``paddle_tpu_torch/kernels/build/variants/``, one ``nvcc`` each,
all at once, beside ``--old-source``: an earlier source that holds the
C entries ``flash_bwd_dkdv_f32`` / ``flash_bwd_dq_f32`` (for example
``git show 46ce780:paddle_tpu_torch/kernels/csrc/flash_attention.cu``,
the scalar design, from before the float32 kernels had libraries of
their own: ``flash_fwd_f32.cu`` and ``flash_bwd_f32.cu``).

Each build's head_dim-64 kernels are summed up from their SASS
(``cuobjdump``): instructions, and how many of them are ``HMMA``. Each
variant is held to the plain versions (1e-4) and its float64 error
printed beside theirs at edge lengths and the training shape, with a
rerun bit-identical; then the default build, every variant and the old
source are timed at ``[16, 12, 1024, 64]`` causal with
``chip_smoke.time_cuda`` (the default first and last, the old source
first and last), beside SDPA's float32 backward alone. ``--train-ab``
then runs ``chip_smoke.phase_train_f32`` (bench.py's widths in float32)
with the default backward and the old one in turns: new, old, new, old.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import time

import torch
import torch.nn.functional as F

import chip_smoke as cs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa

SPLITS = {
    "mask": None,
    "cvt": ('  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));\n'
            "  big &= 0xffffe000u;\n"
            '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(small) '
            ': "f"(x - __uint_as_float(big)));'),
    "round": ("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
              "  small = __float_as_uint(x - __uint_as_float(big)) "
              "+ 0x1000u;"),
}
SPLIT_BODY = re.compile(r"(__device__ inline void split\(float x, uint32_t& "
                        r"big, uint32_t& small\) \{\n)(.*?)(\n\})", re.S)
# (Sq, Sk, D, causal), B = 2, H = 3, then the training shape
EDGES = [(1, 1, 64, True), (63, 63, 64, True), (65, 65, 64, False),
         (200, 200, 64, True), (1000, 1000, 64, True), (63, 200, 64, True),
         (200, 63, 64, True), (1000, 65, 64, False), (1000, 1, 64, True),
         (200, 1000, 64, False)]
TRAIN = (16, 12, 1024, 1024, 64)
ENTRY = fa._entry                   # the port's own library lookup


def variant_sources(spec: str):
    """(name, kernel source, header source) of one ``--variant``."""
    name, dkdv, dq, split = spec.split("/")
    src = (_build.CSRC / "flash_bwd_f32.cu").read_text()
    src = re.sub(r"launch_dkdv<64, [^>]*>", f"launch_dkdv<64, {dkdv}>", src)
    src = re.sub(r"launch_dq<64, [^>]*>", f"launch_dq<64, {dq}>", src)
    header = (_build.CSRC / "tf32x3.cuh").read_text()
    if SPLITS[split] is not None:
        m = SPLIT_BODY.search(header)
        header = header[:m.start(2)] + SPLITS[split] + header[m.end(2):]
    return name, src, header


def build_all(specs, old_source):
    """Compile every variant (and the old source) at once: name ->
    loaded library. The variant's ``tf32x3.cuh`` sits beside its source
    and a copy of ``flash_f32_tiles.cuh``, which ``#include "..."``
    searches first (the includer's directory)."""
    root = _build.BUILD_DIR / "variants"
    jobs = {}
    for spec in specs:
        name, src, header = variant_sources(spec)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_bwd_f32.cu").write_text(src)
        (d / "tf32x3.cuh").write_text(header)
        (d / "flash_f32_tiles.cuh").write_text(
            (_build.CSRC / "flash_f32_tiles.cuh").read_text())
        jobs[name] = (d / "flash_bwd_f32.cu", d / "lib.so")
    if old_source:
        root.mkdir(parents=True, exist_ok=True)
        jobs["old"] = (old_source, root / "old.so")
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, (src, out) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {name}: registers {regs}, spill stores {spills}; "
              f"{sass_summary(jobs[name][1])}", flush=True)
        libs[name] = ctypes.CDLL(str(jobs[name][1]))
    print(f"[build] {len(jobs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return libs


def sass_summary(so) -> str:
    """Instructions and HMMA of the head_dim-64, 16-byte-aligned
    dK/dV and dQ kernels in the library ``so``."""
    cuobjdump = _build._nvcc().replace("nvcc", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kind = "dkdv" if "dkdv_kernel" in line else "dq"
            name = (kind if "ILi64E" in line and
                    line.rstrip().endswith("Lb1EEEvNS_6ParamsE") else None)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if name and m:
            total, hmma = counts.get(name, (0, 0))
            counts[name] = (total + 1, hmma + (m.group(1) == "HMMA"))
    return ", ".join(f"{k} {h} HMMA of {t} instructions"
                     for k, (t, h) in sorted(counts.items()))


def entry(lib, kernel):
    fn = getattr(lib, f"flash_{kernel}_f32")
    n_ptr = {"bwd_dkdv": 8, "bwd_dq": 7}[kernel]
    fn.argtypes = ([ctypes.c_void_p] * (n_ptr + 1) + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernels(lib):
    """``fa._entry`` with the float32 backward taken from ``lib`` (the
    port's own libraries for ``None``)."""
    def pick(kernel, dtype):
        if lib is None or dtype != torch.float32 or kernel == "fwd":
            return ENTRY(kernel, dtype)
        return entry(lib, kernel)
    return pick


def inputs(B, H, Sq, Sk, D, causal, seed, device):
    """q, k, v, dO and the forward's lse and delta."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device=device)
                   for S in (Sq, Sk, Sk, Sq))
    o, lse = fa.flash_fwd_cuda(q, k, v, D ** -0.5, causal)
    return q, k, v, do, lse, fa.bwd_delta(o, do)


def check(name, lib, device) -> None:
    """The variant against the plain versions and float64."""
    worst, ratio, same = 0.0, 0.0, True
    try:
        fa._entry = kernels(lib)
        for Sq, Sk, D, causal in EDGES + [TRAIN[2:] + (True,)]:
            B, H = TRAIN[:2] if Sq == TRAIN[2] else (2, 3)
            args = (*inputs(B, H, Sq, Sk, D, causal, Sq + Sk, device),
                    D ** -0.5, causal)
            got = ((fa.flash_bwd_dq_cuda(*args),)
                   + fa.flash_bwd_dkdv_cuda(*args))
            again = ((fa.flash_bwd_dq_cuda(*args),)
                     + fa.flash_bwd_dkdv_cuda(*args))
            same = same and all(torch.equal(a, b)
                                for a, b in zip(got, again))
            plain = ((fa.flash_bwd_dq_ref(*args),)
                     + fa.flash_bwd_dkdv_ref(*args))
            exact = cs.flash_bwd_f64(*args)
            worst = max(worst, *((a - b).abs().max().item()
                                 for a, b in zip(got, plain)))
            e_k = max((a.double() - w).abs().max().item()
                      for a, w in zip(got, exact))
            e_p = max((a.double() - w).abs().max().item()
                      for a, w in zip(plain, exact))
            ratio = max(ratio, e_k / e_p)
            del got, again, plain, exact
    finally:
        fa._entry = ENTRY
    print(f"[check] {name}: worst error against the plain versions "
          f"{worst:.3e} (tol 1e-4), worst float64 error kernel / plain "
          f"{ratio:.2f}x, rerun bit-identical {same}", flush=True)
    if worst > 1e-4 or not same:
        raise AssertionError(f"variant {name} is wrong")


def time_all(libs, device) -> None:
    q, k, v, do, lse, delta = inputs(*TRAIN, True, 99, device)
    args = (q, k, v, do, lse, delta, 0.125, True)
    order = (["old"] if "old" in libs else []) + ["default"] + [
        n for n in libs if n != "old"] + ["default"] + (
        ["old"] if "old" in libs else [])
    try:
        for name in order:
            fa._entry = kernels(libs.get(name))
            t_kv = cs.time_cuda(lambda: fa.flash_bwd_dkdv_cuda(*args))
            t_q = cs.time_cuda(lambda: fa.flash_bwd_dq_cuda(*args))
            print(f"[time] {name}: dK/dV {t_kv:.4f} ms, dQ {t_q:.4f} ms, "
                  f"pair {t_kv + t_q:.4f} ms", flush=True)
    finally:
        fa._entry = ENTRY
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    kept = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = cs.time_cuda(lambda: torch.autograd.grad(
        kept, (qg, kg, vg), do, retain_graph=True))
    print(f"[time] SDPA float32 backward alone {lib_bwd:.4f} ms at "
          f"{list(TRAIN)} causal", flush=True)


def train_ab(old, device) -> None:
    got = {"new": [], "old": []}
    try:
        for label in ("new", "old", "new", "old"):
            fa._entry = kernels(old if label == "old" else None)
            got[label].append(cs.phase_train_f32(device)["ms_per_step"])
            torch.cuda.empty_cache()
    finally:
        fa._entry = ENTRY
    print(f"[train-ab] float32 training ms/step: new {got['new']}, old "
          f"{got['old']}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--old-source")
    ap.add_argument("--train-ab", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_f32_tune: no CUDA device")
        return 2
    if opts.train_ab and not opts.old_source:
        ap.error("--train-ab needs --old-source")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(cs.card_identity(), flush=True)
    _build.build(["flash_fwd_f32", "flash_bwd_f32"])
    print(f"[build] default: "
          f"{sass_summary(_build.library_path('flash_bwd_f32'))}", flush=True)
    libs = build_all(opts.variant, opts.old_source)
    check("default", None, device)
    for name, lib in libs.items():
        if name != "old":
            check(name, lib, device)
    time_all(libs, device)
    if opts.train_ab:
        train_ab(libs["old"], device)
    print(cs.card_identity(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
