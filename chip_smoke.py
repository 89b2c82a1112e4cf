"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

(``--profile`` adds one more engine run under ``torch.profiler`` and
prints where the device time goes.)

It builds every CUDA kernel of the serving path from the sources in
``paddle_tpu_torch/kernels/csrc`` (into ``paddle_tpu_torch/kernels/build``),
holds each kernel against its plain PyTorch version at the main path's
shapes, drives the serving engine (``GenerationEngine`` over a
GPT-2-small-width ``TorchLM`` with seeded random weights) through a few
requests, checks that the path went through the kernels, and times each
kernel beside its bound, its plain version and a library call. The last
two lines of its output are a JSON object of per-kernel numbers and the
JSON result line. Any failed phase raises; there is no CPU fallback:
without CUDA it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from paddle_tpu_torch.inference.llm import (CacheConfig, GenerationEngine,
                                            ModelSpec, SamplingParams,
                                            SchedulerConfig, TorchLM)
from paddle_tpu_torch.inference.llm.model import (init_lm_params,
                                                  lm_ragged_step)
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as pa

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and dense
# float32 outside the tensor cores, the unit the kernel's arithmetic uses
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# the main path's attention shapes: GPT-2-small heads, the engine's
# default page size, 8 slots over a 1024-token context
H, D, PAGE, B, PAGES_PER_SEQ = 12, 64, 16, 8, 64
# the JAX package's own tolerance for its Pallas tier against the lax
# tier (tests/test_ragged_attention.py), float32 against float32
ATTN_TOL = 2e-5
# the step with the kernel against the step with the plain attention:
# every matmul is shared, the two attentions sum in different orders
# (~1e-6 apart), and that difference compounds through 12 layers; the
# CPU parity tests hold the port's step to the JAX step at the same 1e-4
STEP_TOL = 1e-4

# GPT-2-small widths (paddle_tpu/text/gpt.py GPTConfig.gpt2_small),
# full depth, seeded random float32 weights
GPT2_SMALL = ModelSpec(vocab=50304, d_model=768, num_layers=12,
                       num_heads=12, head_dim=64, max_seq_len=1024)
NEW_TOKENS = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------ ragged mixes


def ragged_mix(kind: str, seed: int, device):
    """A ragged attention input at the main path's shapes.

    ``mix``: a whole-prompt row of 600 tokens, a prefix-cache-hit row
    (100 new tokens over 256 cached ones), five decode rows at contexts
    near 1000, an idle slot, and bucket padding up to 1024 flat tokens.
    ``decode``: eight decode rows at contexts near 1000."""
    g = torch.Generator().manual_seed(seed)
    if kind == "mix":
        q_lens = [600, 100, 1, 1, 1, 1, 1, 0]
        kv_lens = [600, 356, 1000, 997, 1010, 990, 1023, 0]
        width = 1024
    else:
        q_lens = [1] * B
        kv_lens = [1000, 997, 1010, 990, 1023, 1001, 1005, 999]
        width = B
    n_pages = B * PAGES_PER_SEQ + 1          # page 0 is the garbage page
    perm = torch.randperm(n_pages - 1, generator=g) + 1
    page_table = perm.reshape(B, PAGES_PER_SEQ).to(torch.int32)
    k_pool = torch.randn(n_pages, PAGE, H, D, generator=g)
    v_pool = torch.randn(n_pages, PAGE, H, D, generator=g)
    q = torch.randn(width, H, D, generator=g)
    q_starts, start = [], 0
    for ql in q_lens:
        q_starts.append(start)
        start += ql
    i32 = dict(dtype=torch.int32, device=device)
    return dict(q=q.to(device), k_pool=k_pool.to(device),
                v_pool=v_pool.to(device), page_table=page_table.to(device),
                kv_lens=torch.tensor(kv_lens, **i32),
                q_starts=torch.tensor(q_starts, **i32),
                q_lens=torch.tensor(q_lens, **i32)), max(q_lens), start


def attention_work(q_lens, kv_lens):
    """Bytes the function must move (q read, out written, every K and V
    position a row can see read once) and the float32 operations it
    does (QK and PV: 4 * D per visible (query, key) pair per head)."""
    n_tok = sum(q_lens)
    kv_bytes = sum(kv for ql, kv in zip(q_lens, kv_lens) if ql > 0) \
        * H * D * 4 * 2
    qo_bytes = n_tok * H * D * 4 * 2
    pairs = sum((kv - ql + t + 1) for ql, kv in zip(q_lens, kv_lens)
                for t in range(ql))
    return kv_bytes + qo_bytes, pairs * H * 4 * D


def bound(q_lens, kv_lens):
    nbytes, flops = attention_work(q_lens, kv_lens)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phases


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build(_build.KERNELS)
    log(f"[build] {len(logs)} kernel(s) compiled in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernel_vs_plain(device) -> float:
    worst = 0.0
    for kind, seed in (("mix", 0), ("decode", 1)):
        args, max_q, n_used = ragged_mix(kind, seed, device)
        out = pa.ragged_attention(**args, tier="kernel", max_q_len=max_q)
        torch.cuda.synchronize()
        ref = pa.ragged_attention(**args, tier="ref")
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        torch.testing.assert_close(out, ref, rtol=ATTN_TOL, atol=ATTN_TOL)
        if n_used < out.shape[0] and out[n_used:].abs().max().item() != 0.0:
            raise AssertionError("bucket padding tokens are not exact 0")
        log(f"[kernel] {kind}: max_abs_err={err:.3e} (tol {ATTN_TOL}), "
            f"padding exact 0")
        worst = max(worst, err)
    return worst


def phase_step_vs_plain(device, params) -> None:
    """``lm_ragged_step`` at full GPT-2-small width on the mix layout,
    once through the kernel and once through the plain attention, from
    identical pools."""
    spec = GPT2_SMALL
    args, max_q, n_used = ragged_mix("mix", 2, device)
    g = torch.Generator(device=device).manual_seed(3)
    n_pages = args["k_pool"].shape[0]
    shape = (spec.num_layers, n_pages, PAGE, H, D)
    k_pool = torch.randn(shape, generator=g, device=device)
    v_pool = torch.randn(shape, generator=g, device=device)
    tokens = torch.randint(0, spec.vocab, (args["q"].shape[0],),
                           generator=g, device=device, dtype=torch.int32)
    outs = {}
    for tier in ("kernel", "ref"):
        kp, vp = k_pool.clone(), v_pool.clone()
        logits = lm_ragged_step(params, spec, tokens, args["q_starts"],
                                args["q_lens"], args["kv_lens"], kp, vp,
                                args["page_table"], attn_tier=tier,
                                max_q_len=max_q)
        torch.cuda.synchronize()
        outs[tier] = (logits[:n_used], kp, vp)
    (lk, kk, vk), (lr, kr, vr) = outs["kernel"], outs["ref"]
    if not torch.isfinite(lk).all():
        raise AssertionError("non-finite logits from the kernel step")
    torch.testing.assert_close(lk, lr, rtol=STEP_TOL, atol=STEP_TOL)
    # page 0 (the garbage page) takes every padding token's K/V, and a
    # scatter with duplicate indices keeps an arbitrary one: it is never
    # read unmasked, so only the real pages are compared
    torch.testing.assert_close(kk[:, 1:], kr[:, 1:], rtol=STEP_TOL,
                               atol=STEP_TOL)
    torch.testing.assert_close(vk[:, 1:], vr[:, 1:], rtol=STEP_TOL,
                               atol=STEP_TOL)
    log(f"[step] lm_ragged_step kernel vs plain: logits max_abs_err="
        f"{(lk - lr).abs().max().item():.3e} over {n_used} tokens x "
        f"{spec.vocab} (tol {STEP_TOL}), pools agree")


def engine_requests(seed: int):
    """Eight requests, prompts from 17 to 900 tokens; the second and
    third share a 256-token prefix (a prefix-cache hit); six greedy and
    two sampled with fixed seeds."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda n: torch.randint(0, GPT2_SMALL.vocab, (n,),  # noqa: E731
                                   generator=g).tolist()
    shared = rand(256)
    prompts = [rand(900), shared + rand(44), shared + rand(131), rand(17),
               rand(600), rand(333), rand(64), rand(750)]
    sampled = {4: SamplingParams(temperature=0.8, top_k=50, top_p=0.9,
                                 seed=1234),
               6: SamplingParams(temperature=0.8, top_k=50, top_p=0.9,
                                 seed=5678)}
    return [(p, sampled.get(i)) for i, p in enumerate(prompts)]


def run_engine(model, requests):
    spec = model.spec
    engine = GenerationEngine(
        model,
        cache_config=CacheConfig(
            num_layers=spec.num_layers, num_heads=spec.num_heads,
            head_dim=spec.head_dim, num_pages=B * PAGES_PER_SEQ + 1,
            page_size=PAGE, max_slots=B, max_seq_len=spec.max_seq_len),
        scheduler_config=SchedulerConfig(max_slots=B,
                                         max_seq_len=spec.max_seq_len))
    rids = [engine.submit(p, NEW_TOKENS, sp) for p, sp in requests]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return engine, [engine.output_of(r) for r in rids], wall


def phase_engine(model) -> dict:
    """The main path: the serving engine over the GPT-2-small-width
    model. Returns the kernel launch counts of this run."""
    requests = engine_requests(7)
    pa.LAUNCHES.clear()
    engine, outputs, wall = run_engine(model, requests)
    launches = dict(pa.LAUNCHES)
    steps = engine.steps_dispatched
    for (prompt, _), out in zip(requests, outputs):
        if len(out) != NEW_TOKENS:
            raise AssertionError(f"request with a {len(prompt)}-token "
                                 f"prompt finished with {len(out)} tokens")
    want = GPT2_SMALL.num_layers * steps
    if launches.get("ragged_attention", 0) != want:
        raise AssertionError(f"ragged attention kernel launched "
                             f"{launches.get('ragged_attention', 0)} times, "
                             f"expected layers x steps = {want}")
    if engine.cache.prefix_hits < 256 // PAGE:
        raise AssertionError(f"prefix cache served {engine.cache.prefix_hits}"
                             " pages; the shared 256-token prefix was missed")
    n_tok = sum(len(o) for o in outputs)
    log(f"[engine] {len(outputs)} requests x {NEW_TOKENS} tokens in {steps} "
        f"steps, {wall:.3f}s: {n_tok / wall:.1f} tokens/s, "
        f"{1e3 * wall / steps:.2f} ms/step (first run, cold); kernel "
        f"launches {launches.get('ragged_attention', 0)} = layers x steps; "
        f"prefix-cache hits {engine.cache.prefix_hits} pages")
    _, again, wall2 = run_engine(model, requests)
    if again != outputs:
        raise AssertionError("a second identical run gave other tokens")
    log(f"[engine] rerun identical; {n_tok / wall2:.1f} tokens/s, "
        f"{1e3 * wall2 / steps:.2f} ms/step (warm)")
    return launches


def phase_profile(model) -> None:
    """``--profile`` only: one more warm engine run under
    ``torch.profiler``; prints device time per step by kernel and the
    device's busy share of the run's wall time (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    requests = engine_requests(7)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine, _, wall = run_engine(model, requests)
    steps = engine.steps_dispatched

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side events only (kernels, copies, memsets): the host ops
    # that launched them report the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in events)
    if total == 0:
        log("[profile] the profiler recorded no device time: device busy "
            "share not measured")
        return
    log(f"[profile] {steps} steps, wall {wall:.3f}s with the profiler on; "
        f"device busy {total / 1e6:.3f}s = {100 * total / 1e6 / wall:.1f}% "
        f"of wall; {total / 1e3 / steps:.3f} ms device per step")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        log(f"[profile]   {dev_us(e) / 1e3 / steps:8.4f} ms/step "
            f"{100 * dev_us(e) / total:5.1f}%  x{e.count:<6d} {e.key[:90]}")


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn`` over ``reps`` runs, CUDA events around each,
    with the L2 cache flushed before every run (the serving step finds
    each layer's pages cold)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sdpa_inputs(args):
    """Dense per-row layout for the library yardstick: each row's
    context gathered to ``[B, H, S, D]`` and its tokens padded to
    ``[B, H, T, D]``, with a boolean mask of the same visibility."""
    q, kp, vp = args["q"], args["k_pool"], args["v_pool"]
    pt = args["page_table"].long()
    q_lens = args["q_lens"].tolist()
    kv_lens = args["kv_lens"].tolist()
    q_starts = args["q_starts"].tolist()
    S = PAGES_PER_SEQ * PAGE
    T = max(max(q_lens), 1)
    k = kp[pt].reshape(B, S, H, D).transpose(1, 2).contiguous()
    v = vp[pt].reshape(B, S, H, D).transpose(1, 2).contiguous()
    qd = torch.zeros(B, H, T, D, device=q.device)
    mask = torch.zeros(B, 1, T, S, dtype=torch.bool, device=q.device)
    pos = torch.arange(S, device=q.device)
    for b in range(B):
        ql, kv, qs = q_lens[b], kv_lens[b], q_starts[b]
        if ql == 0:
            mask[b, 0, :, 0] = True        # keep padded rows finite
            continue
        qd[b, :, :ql] = q[qs:qs + ql].transpose(0, 1)
        qpos = kv - ql + torch.arange(T, device=q.device)
        mask[b, 0] = (pos[None, :] < kv) & (pos[None, :] <= qpos[:, None])
        mask[b, 0, ql:, 0] = True
    return qd, k, v, mask


def phase_times(device, launches: dict, max_abs_err: float):
    """Kernel, plain version and library yardstick at the decode shape
    (the engine's steady state, reported first) and the mix shape. The
    yardstick times ``F.scaled_dot_product_attention`` alone on the
    already-gathered dense K/V; the port never calls it."""
    shapes = {}
    for kind, seed in (("decode", 1), ("mix", 0)):
        args, max_q, _ = ragged_mix(kind, seed, device)
        ms = time_cuda(lambda: pa.ragged_attention(
            **args, tier="kernel", max_q_len=max_q))
        plain_ms = time_cuda(lambda: pa.ragged_attention(**args, tier="ref"),
                             reps=5, warmup=1)
        qd, k, v, mask = sdpa_inputs(args)
        lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            qd, k, v, attn_mask=mask))
        bms, by = bound(args["q_lens"].tolist(), args["kv_lens"].tolist())
        log(f"[times] ragged_attention {kind}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by})")
        shapes[kind] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": by, "library_ms": lib_ms}
    return [{"name": "ragged_attention", "route": "cuda",
             "source": "paddle_tpu_torch/kernels/csrc/ragged_attention.cu",
             "replaces": "paddle_tpu/kernels/paged_attention.py:465",
             "launches": launches.get("ragged_attention", 0),
             "max_abs_err": max_abs_err, **shapes["decode"],
             "shapes": shapes}]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    phase_build()
    log(f"[card] {card_identity()}")
    max_abs_err = phase_kernel_vs_plain(device)
    model = TorchLM(GPT2_SMALL, init_lm_params(GPT2_SMALL, seed=0,
                                               device=device), device=device)
    phase_step_vs_plain(device, model.params)
    launches = phase_engine(model)
    rows = phase_times(device, launches, max_abs_err)
    if "--profile" in sys.argv[1:]:
        phase_profile(model)
    # the card's name and power limit, exactly as nvidia-smi prints them
    log(card_identity())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
