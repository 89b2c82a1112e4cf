"""Optimizer-state host offload (counterpart of
``paddle_tpu/optimizer/offload.py``; reference
``python/paddle/distributed/fleet/meta_parallel/sharding/
group_sharded_stage3.py:61``, ``offload=True``).

:class:`HostOffloadAdamW` keeps each parameter's float32 master weight
and both moments in pinned host tensors (plain host tensors for a CPU
parameter), and ``beta1_pow`` / ``beta2_pow`` as float32 host scalars;
the device keeps only the 16-bit parameter. ``step()``, per parameter
with a gradient, on a side stream:

- copies the state to the device (``non_blocking=True``);
- runs the update function of ``AdamW(multi_precision=True)``
  (``Adam._update``, the JAX ``Adam._rule``), so the results are
  bit-equal to the on-device optimizer's;
- writes the new 16-bit parameter (a cast of the new master);
- queues the copies of the new state back to the host.

The side stream's memory is reused parameter by parameter, so the
device holds one parameter's state at a time. Before ``step()`` returns
it waits on an event for the copies back, as the JAX package drains its
copies at the end of the step. ``last_step`` holds the step's bytes each
way and the side stream's device time.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from ..core.tensor import Tensor
from .lr import LRScheduler
from .optimizer import AdamW

__all__ = ["HostOffloadAdamW"]

_KEYS = ("master_weight", "moment1", "moment2", "beta1_pow", "beta2_pow")


class HostOffloadAdamW(AdamW):
    """AdamW whose float32 master weights and moments live in host
    memory (see the module docstring).

    Use it in an eager ``loss.backward(); opt.step()`` loop; ``TrainStep``
    takes the optimizer state into its on-device step, so it refuses
    this optimizer.
    """

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay,
                         apply_decay_param_fun=apply_decay_param_fun,
                         grad_clip=grad_clip, multi_precision=True)
        self._host: Dict[int, Dict[str, torch.Tensor]] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self.last_step = {"h2d_bytes": 0, "d2h_bytes": 0, "device_ms": None}

    # --------------------------------------------------------------- state
    def _host_state_for(self, p) -> Dict[str, torch.Tensor]:
        st = self._host.get(id(p))
        if st is None:
            pin = p.is_cuda

            def host(t):
                out = torch.empty(t.shape, dtype=torch.float32,
                                  pin_memory=pin)
                return out.copy_(t)

            master = host(p.detach())                   # one-time read
            one = torch.ones((), dtype=torch.float32)
            st = self._host[id(p)] = {
                "master_weight": master,
                "moment1": host(torch.zeros_like(master)),
                "moment2": host(torch.zeros_like(master)),
                "beta1_pow": host(one), "beta2_pow": host(one)}
        return st

    def _materialize_state(self) -> None:
        for p in self._parameter_list:
            self._host_state_for(p)

    def _state_for(self, p):
        raise RuntimeError(
            "HostOffloadAdamW keeps optimizer state in host memory; it "
            "cannot be compiled into a TrainStep/ShardedTrainStep program. "
            "Run an eager loss.backward()/opt.step() loop, or use "
            "AdamW(multi_precision=True, moment_dtype='bfloat16') for the "
            "on-device low-memory tier.")

    # ---------------------------------------------------------------- step
    def _stream(self, device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    @torch.no_grad()
    def step(self) -> None:
        self._global_step += 1
        params_grads = [(p, p.grad) for p in self._params
                        if p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        h2d = d2h = 0
        marks = {}                       # device -> (start, end) events
        for p, g in params_grads:
            host = self._host_state_for(p)
            stream = self._stream(p.device) if p.is_cuda else None
            if stream is not None and p.device not in marks:
                stream.wait_stream(torch.cuda.current_stream(p.device))
                marks[p.device] = (torch.cuda.Event(enable_timing=True),
                                   torch.cuda.Event(enable_timing=True))
                marks[p.device][0].record(stream)
            if stream is not None:
                g.record_stream(stream)
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                st = {k: v.to(p.device, non_blocking=True)
                      for k, v in host.items()}
                master = st.pop("master_weight")
                self._update([master], [g.to(torch.float32)], [st], lr,
                             self._wd_for(p))
                p.copy_(master)
                st["master_weight"] = master
                for k in _KEYS:
                    host[k].copy_(st[k], non_blocking=True)
            nbytes = sum(v.numel() * 4 for v in host.values())
            h2d, d2h = h2d + nbytes, d2h + nbytes
            p.grad = None
        for dev, (start, end) in marks.items():
            end.record(self._streams[dev])
            torch.cuda.current_stream(dev).wait_stream(self._streams[dev])
        for _, end in marks.values():
            end.synchronize()            # every copy back has landed
        self.last_step = {
            "h2d_bytes": h2d, "d2h_bytes": d2h,
            "device_ms": (sum(s.elapsed_time(e) for s, e in marks.values())
                          if marks else None)}

    # ---------------------------------------------------------- state dict
    def state_dict(self) -> Dict:
        """The JAX layout: ``"<name or param_i>.<master_weight | moment1 |
        moment2 | beta1_pow | beta2_pow>"`` (host tensors; every
        parameter's state made first, zeros before the first step),
        ``global_step`` and ``LR_Scheduler``."""
        self._materialize_state()
        sd = {}
        for i, p in enumerate(self._parameter_list):
            for k, v in self._host[id(p)].items():
                sd[f"{self._key(i, p)}.{k}"] = v.clone().as_subclass(Tensor)
        sd["global_step"] = self._global_step
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict) -> None:
        for i, p in enumerate(self._parameter_list):
            st = self._host_state_for(p)
            for k, v in st.items():
                full = f"{self._key(i, p)}.{k}"
                if full in state_dict:
                    src = state_dict[full]
                    src = (src.detach() if isinstance(src, torch.Tensor)
                           else torch.as_tensor(src))
                    v.copy_(src.to("cpu", torch.float32).reshape(v.shape))
        if "global_step" in state_dict:
            self._global_step = int(state_dict["global_step"])
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                      LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
