"""The static-graph Executor: an eager replay of a recorded Program.

Counterpart of ``paddle_tpu/static/executor.py`` (reference:
``python/paddle/fluid/executor.py:911`` ``Executor``, ``run:1377`` over
``InterpreterCore``). The JAX Executor replays the records once inside
``jax.jit`` and runs the compiled step; here a run replays the pruned
records eagerly on the program's device (the card, or the CPU where the
program was recorded there): every kernel of the recorded ops launches
as it does in eager code (the flash kernels through their ``torch.library``
ops). A run with a backward differentiates the replay with
``torch.autograd.grad`` and, after ``minimize``, applies the optimizer's
update (clipping included) in place. One key is drawn from the default
threefry generator per run, as the JAX Executor draws one, and random ops
inside split from it. Capturing a whole program into one CUDA graph is
later work.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import random as _rng
from ..core.tensor import Tensor, as_tensor, from_numpy
from .program import (Program, Variable, bind_feeds, default_main_program,
                      prune_ops, replaying, run_ops)

__all__ = ["Scope", "global_scope", "scope_guard", "CompiledProgram",
           "Executor"]


class Scope:
    """Name -> persistable tensor holder (reference ``framework/scope.h``)."""

    def __init__(self):
        self._vars: Dict[str, Tensor] = {}

    def var(self, name: str) -> Tensor:
        return self._vars.setdefault(name, as_tensor(torch.zeros(())))

    def find_var(self, name: str) -> Optional[Tensor]:
        return self._vars.get(name)

    def set(self, name: str, value):
        if not isinstance(value, torch.Tensor):
            value = from_numpy(np.asarray(value))
        self._vars[name] = as_tensor(value.detach())


_global_scope = [Scope()]


def global_scope() -> Scope:
    return _global_scope[0]


class scope_guard:
    def __init__(self, scope: Scope):
        self._scope = scope

    def __enter__(self):
        self._prev = _global_scope[0]
        _global_scope[0] = self._scope
        return self._scope

    def __exit__(self, *exc):
        _global_scope[0] = self._prev
        return False


class CompiledProgram:
    """Parity shim: a program runs as recorded."""

    def __init__(self, program: Program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy

    def with_data_parallel(self, *a, **k):
        return self


def _fetch_var(program: Program, f):
    if isinstance(f, Variable):
        return f
    if isinstance(f, str):
        blk = program.global_block()
        if blk.has_var(f):
            return blk.var(f)
        raise ValueError(f"fetch target {f!r} not found in program")
    raise TypeError(f"bad fetch target: {f!r}")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return torch.Tensor.numpy(t.as_subclass(torch.Tensor).cpu())


def _feed_tensor(var: Variable, val) -> torch.Tensor:
    """A feed as a tensor of the data variable's dtype on its device."""
    if isinstance(val, torch.Tensor):
        t = val.detach().as_subclass(torch.Tensor)
    else:
        t = from_numpy(np.asarray(val))
    t = t.to(device=var.device, dtype=var.dtype)
    for d, (want, got) in enumerate(zip(var.desc_shape, t.shape)):
        if want != -1 and want != got:
            raise ValueError(f"feed {var.name!r}: dim {d} is {got}, the "
                             f"program declares {want}")
    if t.dim() != len(var.desc_shape):
        raise ValueError(f"feed {var.name!r} has {t.dim()} dims, the "
                         f"program declares {len(var.desc_shape)}")
    return t


class Executor:
    def __init__(self, place=None):
        self.place = place
        self._pruned: Dict[tuple, list] = {}

    def close(self):
        self._pruned.clear()

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, **kwargs):
        from .io import ExportedProgram

        program = program if program is not None else default_main_program()
        if isinstance(program, CompiledProgram):
            program = program._program
        if isinstance(program, ExportedProgram):
            return program._run(feed or {}, return_numpy=return_numpy)
        feed = feed or {}
        fetch_list = fetch_list or []

        # startup program: the parameters' initial values, taken at the
        # first run and restored at every later one
        if not program.ops and program._startup_params and not fetch_list:
            with torch.no_grad():
                if program._startup_values is None:
                    program._startup_values = [
                        p.detach().clone() for p in program._startup_params]
                else:
                    for p, v in zip(program._startup_params,
                                    program._startup_values):
                        p.copy_(v)
            return []
        if not program.ops and not fetch_list:
            return []

        fetch_vars = [_fetch_var(program, f) for f in fetch_list]
        opt_entry = program._opt
        bwd = program._backward
        grad_map, wrt = {}, []
        if bwd is not None:
            loss_var, pairs = bwd
            for ref, gv in pairs:
                grad_map[id(gv)] = len(wrt)
                wrt.append(ref)
        need_grads = opt_entry is not None or any(
            id(v) in grad_map for v in fetch_vars)
        loss_var = bwd[0] if bwd is not None else None

        env = {}
        by_name = {v.name: v for v in program._data_vars}
        for name, val in feed.items():
            var = by_name.get(name)
            if var is None:
                raise ValueError(f"feed {name!r} is no data variable of the "
                                 "program")
            env[id(var)] = _feed_tensor(var, val)
        key = (id(program), program._version,
               tuple(id(v) for v in fetch_vars), need_grads)
        ops = self._pruned.get(key)
        if ops is None:
            targets = list(fetch_vars) + ([loss_var] if need_grads else [])
            ops = prune_ops(program, targets)
            self._pruned[key] = ops
        bind = bind_feeds(program, env)
        rng_key = _rng.default_generator.next_key()

        grads = None
        with _rng.trace_key_scope(rng_key), replaying():
            if not need_grads:
                with torch.no_grad():
                    run_ops(ops, env, bind)
            else:
                diff = []
                for ref in wrt:
                    if isinstance(ref, Variable):
                        t = env[id(ref)].detach().requires_grad_(True)
                        env[id(ref)] = t
                        diff.append(t)
                    else:
                        diff.append(ref)
                with torch.enable_grad():
                    run_ops(ops, env, bind)
                    loss = env[id(loss_var)]
                    if loss.dim() != 0:
                        loss = loss.sum()
                    got = torch.autograd.grad(loss, diff, allow_unused=True)
                grads = [torch.zeros_like(d) if g is None else g
                         for d, g in zip(diff, got)]

        if opt_entry is not None:
            opt, _ = opt_entry
            gmap = {id(ref): g for ref, g in zip(wrt, grads)
                    if not isinstance(ref, Variable)}
            params_grads = [(p, gmap[id(p)]) for p in opt._params
                            if id(p) in gmap]
            with torch.no_grad(), replaying():
                if opt._grad_clip is not None:
                    params_grads = opt._grad_clip(params_grads)
                opt._apply(params_grads, opt.get_lr())
            opt._global_step += 1

        fetches = []
        for v in fetch_vars:
            if id(v) in grad_map:
                fetches.append(grads[grad_map[id(v)]])
            elif id(v) in env:
                fetches.append(env[id(v)])
            else:
                raise RuntimeError(f"fetch {v.name!r} was not computed")
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return [as_tensor(f.detach().as_subclass(torch.Tensor))
                for f in fetches]
