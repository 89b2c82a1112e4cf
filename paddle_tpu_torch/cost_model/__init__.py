"""``paddle.cost_model``: measured per-op cost of a static Program.

Counterpart of ``paddle_tpu/cost_model/__init__.py`` (reference:
``python/paddle/cost_model/cost_model.py``). Each op record of the
program is replayed alone on its device, with the outputs of the
records before it as inputs, and timed between two
``torch.cuda.synchronize()`` calls (the JAX package's
``block_until_ready``): an upper bound that ranks the ops. The whole
program is then timed through ``Executor.run``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["CostModel"]


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class CostModel:
    def __init__(self):
        self._op_costs: Dict[str, float] = {}

    def profile_measure(self, main_program, startup_program=None,
                        device="gpu", fetch_cost_list=("time",),
                        feed: Optional[dict] = None, repeat: int = 3):
        """Per-record wall time (ms, under ``"{op_name}#{i}"``) and the
        whole program's (``program_time_ms``, through the Executor).

        ``feed`` gives the data variables' values; a variable without
        one is zeros, each unknown dim 1. ``startup_program`` runs
        first. Ops run where the program's tensors are (``device``
        chooses nothing). Only ``"time"`` costs are measured: any other
        entry of ``fetch_cost_list`` raises."""
        from ..core import random as _rng
        from ..static.executor import Executor, _feed_tensor
        from ..static.program import bind_feeds, replaying, run_ops

        unsupported = [c for c in fetch_cost_list if c != "time"]
        if unsupported:
            raise ValueError(f"only 'time' costs are measurable here; "
                             f"got {unsupported}")
        if startup_program is not None:
            Executor().run(startup_program)

        prog = main_program
        feed = dict(feed or {})
        env = {}
        for v in prog._data_vars:
            if v.name in feed:
                env[id(v)] = _feed_tensor(v, feed[v.name])
            else:
                shape = tuple(1 if d == -1 else d for d in v.desc_shape)
                env[id(v)] = torch.zeros(shape, dtype=v.dtype,
                                         device=v.device)
        bind = bind_feeds(prog, env)

        per_op = {}
        with torch.no_grad(), replaying(), \
                _rng.trace_key_scope(_rng.default_generator.next_key()):
            for i, rec in enumerate(prog.ops):
                run_ops([rec], env, bind)  # warm
                _sync()
                t0 = time.perf_counter()
                for _ in range(repeat):
                    run_ops([rec], env, bind)
                _sync()
                per_op[f"{rec.op_name}#{i}"] = \
                    (time.perf_counter() - t0) / repeat * 1e3

        total = None
        if prog.ops:
            exe = Executor()
            run_feed = {v.name: env[id(v)] for v in prog._data_vars}
            fetches = [prog.ops[-1].outputs[0]]
            exe.run(prog, feed=run_feed, fetch_list=fetches,
                    return_numpy=False)  # warm
            _sync()
            t0 = time.perf_counter()
            for _ in range(repeat):
                exe.run(prog, feed=run_feed, fetch_list=fetches,
                        return_numpy=False)
            _sync()
            total = (time.perf_counter() - t0) / repeat * 1e3

        self._op_costs = per_op
        return {"op_time_ms": per_op, "program_time_ms": total}

    def get_op_cost(self, op_name: str) -> float:
        """Mean measured cost (ms) over the records of this op type."""
        vals = [v for k, v in self._op_costs.items()
                if k.split("#")[0] == op_name]
        return float(np.mean(vals)) if vals else 0.0

    def static_cost_data(self):
        return dict(self._op_costs)
