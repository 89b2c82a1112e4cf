"""Variants of the paged decode kernel, timed on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    PYTHONPATH=. python3 chip_tools/decode_tune.py \\
        [--variant NAME/KEY=VALUE/...] [--old-source FILE] [--e2e]

Each ``--variant`` is a copy of ``paddle_tpu_torch/kernels/csrc/
paged_attention.cu`` with some of its launch constants rewritten:

- ``warps=N``: ``kWarps`` (most warps a block);
- ``ppw=N``: ``kPagesPerWarp`` (a warp for every N pages of the table);
- ``cluster=N``: ``kMaxCluster`` (most blocks a (slot, head), fewer
  where the card would not hold them all at once; 1 is one block a
  pair);
- ``ns=N``: ``kStages`` (a warp's ring: pages it holds, in flight and
  being read).

For example ``--variant "c2/cluster=2/warps=8" --variant "ns3/ns=3"``.
Every variant is built (one ``nvcc`` each, all at once, into
``paddle_tpu_torch/kernels/build/decode_variants/``; ``#include "..."``
finds the port's ``paged_walk.cuh``) beside ``--old-source``, an earlier
``paged_attention.cu`` built where it lies, so that its own headers beside
it come first (for example the SIMT walk: ``git show 6afcada:paddle_tpu_
torch/kernels/csrc/paged_attention.cu`` and ``.../paged_walk.cuh`` into
one directory; the chip machine's copy has no ``.git``: extract them
before the call).

Each build is held to the plain version at ``chip_smoke.py``'s decode
shape (GPT-2-small geometry, eight slots of 900-1023 tokens and one of 0)
and at the card tests' geometries with slots of 0, 1 and up to the whole
table: within 2e-5, a seq_len-0 slot exact 0, a rerun bit-identical. Then
the decode shape, and the same heads with one slot of 1000 tokens (the
per-tier path's batch), are timed with ``chip_smoke.time_cuda`` in the
order old, default, every variant, default, old, beside the byte bound,
and beside two floors: a one-element add (what the timing costs) and a
sum over as many contiguous bytes (what streaming them costs).
``--e2e`` also times ``lm_decode`` (GPT-2-small, 12 layers, random
weights) at both batches, the median ms of 30 steps on the host's clock,
with the port's kernel and the old one in turns (new, old, three times).
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import time

import torch

import chip_smoke as cs
from paddle_tpu_torch.inference.llm.model import init_lm_params, lm_decode
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as pa

SOURCE = "paged_attention.cu"
KEYS = {"warps": "kWarps", "ppw": "kPagesPerWarp", "cluster": "kMaxCluster",
        "ns": "kStages"}
PATTERNS = {key: re.compile(rf"constexpr int {name} = \d+;")
            for key, name in KEYS.items()}
ENTRY = pa._entry                  # the port's own library lookup
# (H, D, page, pages a row): the card tests' geometries and tables wide
# enough for clusters of two to four blocks
EDGES = [(2, 16, 8, 4), (12, 64, 16, 64), (4, 128, 32, 8), (3, 40, 16, 6),
         (2, 16, 8, 40), (4, 128, 32, 64)]


def variant_source(spec: str):
    """(name, source) of one ``--variant``."""
    name, *assigns = spec.split("/")
    src = (_build.CSRC / SOURCE).read_text()
    for assign in assigns:
        key, value = (x.strip() for x in assign.split("=", 1))
        if key not in KEYS:
            raise ValueError(f"unknown variant key {key!r} in {spec!r}")
        src = PATTERNS[key].sub(f"constexpr int {KEYS[key]} = {int(value)};",
                                src)
    return name, src


def build_all(specs, old_source):
    """Compile every variant and the old source at once: {name: library}."""
    root = _build.BUILD_DIR / "decode_variants"
    jobs = {}
    for name, text in (variant_source(s) for s in specs):
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE).write_text(text)
        jobs[name] = (d / SOURCE, d / "paged_attention.so")
    if old_source:
        root.mkdir(parents=True, exist_ok=True)
        jobs["old"] = (old_source, root / "old_paged_attention.so")
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
        print(f"[build] {name}: registers {regs}, spill stores {spills}",
              flush=True)
        libs[name] = ctypes.CDLL(str(jobs[name][1]))
    print(f"[build] {len(jobs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return libs


def one_slot(args):
    """The decode shape's heads with one slot of 1000 tokens: the
    per-tier path's batch."""
    return dict(args, q=args["q"][:1].contiguous(),
                page_table=args["page_table"][:1].contiguous(),
                seq_lens=torch.full_like(args["seq_lens"][:1], 1000))


def cases(device):
    """(label, args) to check: the decode shape, one slot, and each edge
    geometry with slots of every kind."""
    smoke = cs.per_tier_mix("decode", 40, device)
    out = [("decode", smoke), ("one slot", one_slot(smoke))]
    for H, D, page, pps in EDGES:
        g = torch.Generator().manual_seed(D + pps)
        S = page * pps
        seq = [S, 1, 0, S // 2 + 3, 5, S - 1]
        n_pages = len(seq) * pps + 1
        perm = torch.randperm(n_pages - 1, generator=g) + 1
        i32 = dict(dtype=torch.int32, device=device)
        out.append((f"H {H} D {D} page {page} x {pps}", dict(
            q=torch.randn(len(seq), H, D, generator=g).to(device),
            k_pool=torch.randn(n_pages, page, H, D, generator=g).to(device),
            v_pool=torch.randn(n_pages, page, H, D, generator=g).to(device),
            page_table=perm.reshape(len(seq), pps).to(**i32),
            seq_lens=torch.tensor(seq, **i32))))
    return out


def run(args):
    return pa.paged_attention(**args, tier="kernel")


def check(name, pick, all_cases) -> None:
    """One build against the plain version at every case."""
    worst = 0.0
    try:
        pa._entry = pick
        for label, args in all_cases:
            out, again = run(args), run(args)
            torch.cuda.synchronize()
            ref = pa.paged_attention(**args, tier="ref")
            worst = max(worst, (out - ref).abs().max().item())
            torch.testing.assert_close(out, ref, rtol=cs.ATTN_TOL,
                                       atol=cs.ATTN_TOL,
                                       msg=f"{name} {label}")
            if not torch.equal(out, again):
                raise AssertionError(f"{name} {label}: a rerun differs")
            empty = (args["seq_lens"] == 0).nonzero().flatten().tolist()
            if empty and out[empty].abs().max().item() != 0:
                raise AssertionError(f"{name} {label}: seq_len 0 not 0")
    finally:
        pa._entry = ENTRY
    print(f"[check] {name}: {len(all_cases)} cases within 2e-5 of the plain "
          f"version (worst {worst:.3e}), seq_len 0 exact 0, reruns "
          "bit-identical", flush=True)


def order_of(picks):
    names = [n for n in picks if n not in ("default", "old")]
    old = ["old"] if "old" in picks else []
    return old + ["default"] + names + ["default"] + old


def time_all(picks, all_cases) -> None:
    for label, args in all_cases[:2]:
        nbytes, flops = cs.per_tier_work(args)
        bound_ms = max(nbytes / cs.HBM_BYTES_PER_S,
                       flops / cs.FP32_FLOPS_PER_S) * 1e3
        times = []
        try:
            for name in order_of(picks):
                pa._entry = picks[name]
                times.append(f"{name} {cs.time_cuda(lambda: run(args)):.4f}")
        finally:
            pa._entry = ENTRY
        print(f"[time] {label} {list(args['q'].shape)}: " + ", ".join(times)
              + f" ms; bound {bound_ms:.4f} (bytes: {nbytes})", flush=True)


def floors(args) -> None:
    """What the timing itself costs and what streaming costs: a one-element
    add (the floor of ``chip_smoke.time_cuda``), and a float32 sum over as
    many contiguous bytes as the decode shape's K/V reads (that read at the
    bandwidth a plain PyTorch reduction reaches)."""
    one = torch.zeros(1, device="cuda")
    nbytes, _ = cs.per_tier_work(args)
    flat = torch.randn(nbytes // 4, device="cuda")
    empty_ms = cs.time_cuda(lambda: one.add_(1))
    sum_ms = cs.time_cuda(lambda: flat.sum())
    print(f"[floor] one-element add {empty_ms:.4f} ms; sum over {nbytes} "
          f"contiguous bytes {sum_ms:.4f} ms ({nbytes / sum_ms / 1e9:.3f} "
          "TB/s)", flush=True)


def decode_loop(model_params, spec, args, steps: int) -> float:
    """Median ms a step of ``lm_decode`` at ``args``'s slots, over
    ``steps`` steps after two warm ones (host clock, each step ending in
    a synchronize)."""
    B = args["q"].shape[0]
    L, H, D = spec.num_layers, spec.num_heads, spec.head_dim
    n_pages, page = args["k_pool"].shape[:2]
    g = torch.Generator(device="cuda").manual_seed(5)
    pools = [torch.randn(L, n_pages, page, H, D, generator=g, device="cuda")
             for _ in range(2)]
    tokens = torch.arange(B, dtype=torch.int32, device="cuda") + 11
    positions = (args["seq_lens"] - 1).clamp(min=0)
    times = []
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm_decode(model_params, spec, tokens, positions, *pools,
                  args["page_table"])
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_e2e(picks, all_cases) -> None:
    spec = cs.GPT2_SMALL
    params = init_lm_params(spec, seed=0, device=torch.device("cuda"))
    turns = ["default", "old"] * 3 if "old" in picks else ["default"] * 3
    for label, args in all_cases[:2]:
        got = []
        try:
            for name in turns:
                pa._entry = picks[name]
                pa.LAUNCHES.clear()
                ms = decode_loop(params, spec, args, 30)
                assert pa.LAUNCHES[pa.PAGED_KERNEL] == 32 * spec.num_layers
                got.append(f"{name} {ms:.3f}")
        finally:
            pa._entry = ENTRY
        print(f"[e2e] lm_decode {label} ({spec.num_layers} layers, "
              f"{args['q'].shape[0]} slots): ms/step " + ", ".join(got),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--old-source")
    ap.add_argument("--e2e", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_tune: no CUDA device")
        return 2
    device = torch.device("cuda")
    print(cs.card_identity(), flush=True)
    _build.build(["paged_attention"])
    libs = build_all(opts.variant, opts.old_source)
    all_cases = cases(device)
    picks = {"default": ENTRY}
    for name in sorted(libs, key=lambda n: n == "old"):
        picks[name] = cs.ragged_entry({"paged_attention_f32": libs[name]})
    for name, pick in picks.items():
        check(name, pick, all_cases)
    time_all(picks, all_cases)
    floors(all_cases[0][1])
    if opts.e2e:
        time_e2e(picks, all_cases)
    print(cs.card_identity(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
