"""Run some of ``chip_smoke.py``'s phases alone on the card.

From the repository root, on a machine with one GPU::

    PYTHONPATH=. python3 chip_tools/smoke_phases.py phase_audio ...

It builds every kernel (``phase_build``, one nvcc per source), then runs
each named phase (default: the long tail's profiler / cost-model,
quantization, sparse, distribution and ONNX phases) with
``torch.device("cuda")``. A failing phase prints its
traceback and the next one runs; the exit code is 1 if any failed.
"""
import sys
import time
import traceback

import torch

DEFAULT = ("phase_profiler_cost", "phase_quantization", "phase_sparse",
           "phase_distribution", "phase_onnx")


def main() -> int:
    import chip_smoke as cs

    t0 = time.perf_counter()
    cs.phase_build(cs.triple_op(), {})
    cs.log(f"[phases] build {time.perf_counter() - t0:.1f}s; "
           f"{cs.card_identity()}")
    dev = torch.device("cuda")
    failed = []
    for name in sys.argv[1:] or DEFAULT:
        t = time.perf_counter()
        try:
            getattr(cs, name)(dev)
        except Exception:           # report it and run the next phase
            traceback.print_exc()
            failed.append(name)
        cs.log(f"[phases] {name} {time.perf_counter() - t:.1f}s")
        torch.cuda.empty_cache()
    cs.log(f"[phases] all {time.perf_counter() - t0:.1f}s; failed {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
