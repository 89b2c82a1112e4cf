"""The training main path of two trees side by side, timed on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    PYTHONPATH=. python3 chip_tools/train_ab.py --parent DIR

``DIR`` holds an earlier tree's ``paddle_tpu_torch/`` and
``chip_smoke.py`` (for example ``git archive <commit> paddle_tpu_torch
chip_smoke.py`` unpacked into the gitignored ``chip_checkout/``). Each
run is a fresh process in one tree (parent, this tree, this tree,
parent) that runs ``chip_smoke.phase_train``'s protocol: bench.py's
configuration (GPT-2-small, 12 layers, 16 x 1024 tokens, AdamW 1e-4,
AMP O2 bf16, ``TrainStep`` of 8 steps a call), one warm call, then
``TRAIN_CALLS`` timed calls, each call's losses read after the next is
queued. It prints each run's losses and ms/step and the host time of
one flash-attention forward call at a tiny shape (bf16 [1, 1, 128, 64]:
the median wall time of 2000 calls, the enqueue alone), and fails
unless every run's losses are bit-equal. The flash libraries build in
each tree at first use.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

RUN_ORDER = ("parent", "change", "change", "parent")
HOST_CALLS = 2000


def run_one() -> dict:
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.amp import decorate
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    q = torch.randn(1, 1, 128, 64, device=dev, dtype=torch.bfloat16)
    for _ in range(10):
        fa.flash_attention_bhsd(q, q, q, causal=True)
    torch.cuda.synchronize()
    walls = []
    for _ in range(HOST_CALLS):
        t0 = time.perf_counter()
        fa.flash_attention_bhsd(q, q, q, causal=True)
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    model = cs.train_model(dev, cs.TRAIN_CFG["num_hidden_layers"])
    opt = AdamW(learning_rate=cs.TRAIN_LR, parameters=model.parameters())
    model, opt = decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, cs.loss_fn, opt, steps_per_call=cs.TRAIN_K)
    g = torch.Generator(device=dev).manual_seed(7)
    ids = torch.randint(0, cs.TRAIN_CFG["vocab_size"],
                        (cs.TRAIN_K, cs.TRAIN_BATCH, cs.TRAIN_SEQ),
                        generator=g, device=dev)
    losses = [step(ids, ids).tolist()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prev = None
    for _ in range(cs.TRAIN_CALLS):
        cur = step(ids, ids)
        if prev is not None:
            losses.append(prev.tolist())
        prev = cur
    losses.append(prev.tolist())
    wall = time.perf_counter() - t0
    return {"losses": losses,
            "ms_per_step": 1e3 * wall / (cs.TRAIN_K * cs.TRAIN_CALLS),
            "flash_call_host_us": 1e6 * statistics.median(walls),
            "card": cs.card_identity()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the earlier tree")
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        print(json.dumps(run_one()), flush=True)
        return 0
    roots = {"parent": os.path.abspath(args.parent), "change": os.getcwd()}
    runs = []
    for label in RUN_ORDER:
        env = dict(os.environ, PYTHONPATH=roots[label])
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run"],
            cwd=roots[label], env=env, capture_output=True, text=True,
            timeout=1200)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        got = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append((label, got))
        print(f"[train_ab] {label}: {got['ms_per_step']:.2f} ms/step, flash "
              f"call host {got['flash_call_host_us']:.1f} us, first losses "
              f"{got['losses'][0][:3]} ({got['card']})", flush=True)
    first = runs[0][1]["losses"]
    same = all(r["losses"] == first for _, r in runs)
    print(json.dumps({"losses_bit_equal": same, "runs": [
        {"tree": label, "ms_per_step": r["ms_per_step"],
         "flash_call_host_us": r["flash_call_host_us"]}
        for label, r in runs], "card": runs[0][1]["card"]}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
