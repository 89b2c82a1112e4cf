"""Variants of the float32 flash forward, timed on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    PYTHONPATH=. python3 chip_tools/flash_fwd_f32_tune.py \\
        [--variant NAME/D64 ...] [--old-source FILE] [--parent-bwd FILE] \\
        [--train-ab]

Each ``--variant`` is a copy of ``paddle_tpu_torch/kernels/csrc/
flash_fwd_f32.cu`` whose head_dim-64 launch line takes ``D64`` = "WARPS,
MT, BK" (warps a block, 16-row tiles a warp, keys a walked tile). Every
build goes to ``paddle_tpu_torch/kernels/build/variants/``, one ``nvcc``
each, all at once, beside ``--old-source``, an earlier source of the C
entry ``flash_fwd_f32`` (for example ``git show 1b5748f:paddle_tpu_torch/
kernels/csrc/flash_attention.cu``, the scalar design), and
``--parent-bwd``, an earlier ``flash_bwd_f32.cu`` (for example ``git show
1b5748f:paddle_tpu_torch/kernels/csrc/flash_bwd_f32.cu``, from before its
helpers moved into ``flash_f32_tiles.cuh``). The chip machine's copy of
the repository has no ``.git``: extract both before the call.

Each build's head_dim-64 forward is summed up from its SASS
(``cuobjdump``): instructions, and how many of them are ``HMMA``. Each
variant is held to the plain version (o and lse at 2e-5) and its float64
error printed beside the plain version's at edge lengths and the
training shape, with a rerun bit-identical. With ``--parent-bwd`` the
port's dK/dV and dQ must give the same bits as the parent's build at
the same shapes. Then the default build, every variant and the old
source are timed at ``[16, 12, 1024, 64]`` causal with
``chip_smoke.time_cuda`` (the default first and last, the old source
first and last), beside SDPA's float32 forward. ``--train-ab`` then runs
``chip_smoke.phase_train_f32`` (bench.py's widths in float32) with the
default forward and the old one in turns: new, old, new, old.
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
from chip_tools import flash_bwd_f32_tune as bwd_tool
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa

LAUNCH = re.compile(r"launch<64, [^>]*>")
# (Sq, Sk, D, causal), B = 2, H = 3, then the training shape
EDGES = bwd_tool.EDGES + [(65, 65, 128, True), (200, 1000, 128, False),
                          (1000, 200, 128, True)]
TRAIN = (16, 12, 1024, 1024, 64)
ENTRY = fa._entry                   # the port's own library lookup


def variant_source(spec: str):
    """(name, kernel source) of one ``--variant``."""
    name, d64 = spec.split("/")
    src = (_build.CSRC / "flash_fwd_f32.cu").read_text()
    return name, LAUNCH.sub(f"launch<64, {d64}>", src)


def build_all(specs, old_source, parent_bwd):
    """Compile every variant, the old source and the parent's backward at
    once: name -> loaded library. ``#include "..."`` finds the port's
    headers through ``-I``."""
    root = _build.BUILD_DIR / "variants"
    jobs = {}
    for spec in specs:
        name, src = variant_source(spec)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_fwd_f32.cu").write_text(src)
        jobs[name] = (d / "flash_fwd_f32.cu", d / "lib.so")
    root.mkdir(parents=True, exist_ok=True)
    if old_source:
        jobs["old"] = (old_source, root / "old.so")
    if parent_bwd:
        jobs["parent_bwd"] = (parent_bwd, root / "parent_bwd.so")
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
    """Instructions and HMMA of the head_dim-64, 16-byte-aligned forward
    kernel in the library ``so``."""
    cuobjdump = _build._nvcc().replace("nvcc", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True).stdout
    total = hmma = 0
    on = False
    for line in sass.splitlines():
        if "Function :" in line:
            on = ("fwd_kernelILi64E" in line
                  and line.rstrip().endswith("Lb1EEEvNS_6ParamsE"))
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if on and m:
            total += 1
            hmma += m.group(1) == "HMMA"
    return f"fwd {hmma} HMMA of {total} instructions" if total else "no fwd"


def check(name, lib, device) -> None:
    """The variant's forward (the port's for ``None``) against the plain
    version and float64."""
    worst, ratio, same = 0.0, 0.0, True
    try:
        fa._entry = ENTRY if lib is None else cs.f32_fwd_from(lib)
        for Sq, Sk, D, causal in EDGES + [TRAIN[2:] + (True,)]:
            B, H = TRAIN[:2] if Sq == TRAIN[2] else (2, 3)
            q, k, v, _ = cs.flash_inputs((B, H, Sq, Sk, D), torch.float32,
                                         Sq + Sk, device)
            got = fa.flash_fwd_cuda(q, k, v, D ** -0.5, causal)
            again = fa.flash_fwd_cuda(q, k, v, D ** -0.5, causal)
            same = same and all(torch.equal(a, b) for a, b in zip(got, again))
            plain = fa.flash_fwd_ref(q, k, v, D ** -0.5, causal)
            exact = cs.flash_fwd_f64(q, k, v, D ** -0.5, causal)
            worst = max(worst, *((a - b).abs().max().item()
                                 for a, b in zip(got, plain)))
            e_k = max((a.double() - w).abs().max().item()
                      for a, w in zip(got, exact))
            e_p = max((a.double() - w).abs().max().item()
                      for a, w in zip(plain, exact))
            ratio = max(ratio, e_k / e_p if e_p else float("inf"))
            del got, again, plain, exact
    finally:
        fa._entry = ENTRY
    print(f"[check] {name}: worst error against the plain version "
          f"{worst:.3e} (tol 2e-5), worst float64 error kernel / plain "
          f"{ratio:.2f}x, rerun bit-identical {same}", flush=True)
    if worst > 2e-5 or not same:
        raise AssertionError(f"variant {name} is wrong")


def check_bwd_bits(parent, device) -> None:
    """The port's dK/dV and dQ against the parent's build of
    ``flash_bwd_f32.cu``: the same bits at every shape."""
    pick = bwd_tool.kernels(parent)
    for Sq, Sk, D, causal in EDGES + [TRAIN[2:] + (True,)]:
        B, H = TRAIN[:2] if Sq == TRAIN[2] else (2, 3)
        args = (*bwd_tool.inputs(B, H, Sq, Sk, D, causal, Sq + Sk, device),
                D ** -0.5, causal)
        got = (fa.flash_bwd_dq_cuda(*args),) + fa.flash_bwd_dkdv_cuda(*args)
        try:
            fa._entry = pick
            want = ((fa.flash_bwd_dq_cuda(*args),)
                    + fa.flash_bwd_dkdv_cuda(*args))
        finally:
            fa._entry = ENTRY
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"the float32 backward's bits moved at "
                                 f"{(B, H, Sq, Sk, D, causal)}")
    print(f"[check] float32 dK/dV and dQ bit-identical to the parent's "
          f"build at {len(EDGES) + 1} shapes", flush=True)


def time_all(libs, device) -> None:
    q, k, v, _ = cs.flash_inputs(TRAIN, torch.float32, 99, device)
    fwd = [n for n in libs if n not in ("old", "parent_bwd")]
    old = ["old"] if "old" in libs else []
    order = old + ["default"] + fwd + ["default"] + old
    try:
        for name in order:
            fa._entry = (ENTRY if name == "default"
                         else cs.f32_fwd_from(libs[name]))
            ms = cs.time_cuda(lambda: fa.flash_fwd_cuda(q, k, v, 0.125, True))
            print(f"[time] {name}: forward {ms:.4f} ms", flush=True)
    finally:
        fa._entry = ENTRY
    lib_fwd = cs.time_cuda(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    print(f"[time] SDPA float32 forward {lib_fwd:.4f} ms at {list(TRAIN)} "
          "causal", flush=True)


def train_ab(old, device) -> None:
    got = {"new": [], "old": []}
    try:
        for label in ("new", "old", "new", "old"):
            fa._entry = ENTRY if label == "new" else cs.f32_fwd_from(old)
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
    ap.add_argument("--parent-bwd")
    ap.add_argument("--train-ab", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_f32_tune: no CUDA device")
        return 2
    if opts.train_ab and not opts.old_source:
        ap.error("--train-ab needs --old-source")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(cs.card_identity(), flush=True)
    _build.build(["flash_fwd_f32", "flash_bwd_f32"])
    print(f"[build] default: "
          f"{sass_summary(_build.library_path('flash_fwd_f32'))}", flush=True)
    libs = build_all(opts.variant, opts.old_source, opts.parent_bwd)
    check("default", None, device)
    for name, lib in libs.items():
        if name not in ("old", "parent_bwd"):
            check(name, lib, device)
    if "parent_bwd" in libs:
        check_bwd_bits(libs["parent_bwd"], device)
    time_all(libs, device)
    if opts.train_ab:
        train_ab(libs["old"], device)
    print(cs.card_identity(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
