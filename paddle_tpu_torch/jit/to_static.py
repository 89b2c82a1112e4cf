"""The step compiler's counterpart: ``to_static``, ``TrainStep``,
``save`` / ``load``.

Counterpart of ``paddle_tpu/jit/to_static.py``.

``to_static`` / :class:`StaticFunction`. The JAX ``StaticFunction`` jits
a forward under ``no_grad`` with the layer's parameters and buffers as
traced inputs, cached by the argument tree, its static leaves and the
traced leaves' shapes and dtypes. Here the function goes through the
dy2static AST pass (``jit/dy2static``) and each signature (the same
key, plus the devices and the layer's training flag) becomes one CUDA
graph, the serving engine's idiom:

- the first call of a signature runs eagerly (the warm-up);
- the second captures the function over static copies of its tensor
  inputs on a side stream (nothing runs), then replays it;
- each later call copies its inputs in and replays; outputs come back
  as fresh tensors, never the graph's buffers;
- parameters are read in place by the graph, so an in-place update (an
  optimizer step) is seen by the next replay; a parameter or buffer
  with new storage (``set_state_dict`` of another tensor, ``.to()``)
  shows as a changed ``data_ptr`` at the next call and is captured
  anew;
- every call draws one key from the default threefry generator (the
  JAX ``next_key()`` per call), on every path. The dropout kernel takes
  its key as host integers, so a captured graph would replay one mask:
  a signature that draws a key while captured is not captured;
- a signature whose capture raises ``CaptureUnsupported`` (a
  tensor-predicate ``while``, a traced ``print`` or ``assert``, a host
  op: dy2static refuses these inside a capture) or fails in CUDA (a host
  read such as ``.item()``), or that takes a CPU tensor, draws a key or
  is called on the CPU, runs eagerly on every call; the partial graph is
  dropped, and :meth:`StaticFunction.capture_report` says why;
- while ``FLAGS_check_nan_inf`` is on (``amp.debugging``'s tensor
  checker), every signature runs eagerly, so each op's outputs are
  checked and a NaN raises as the JAX function does under
  ``jax_debug_nans``; the report gives that as the reason, and a
  signature captures or replays again once the flag is off.

Kernel launch counters are Python: a replay runs no Python. A captured
signature counts its kernels once at capture and, at every replay, adds
what the capture counted.

``save`` / ``load`` / :class:`TranslatedLayer`: ``torch.export`` of the
forward (through dy2static) with every ``None`` dimension of the
``input_spec`` a ``torch.export.Dim`` shared per axis position, the
parameters as inputs; written with ``torch.export.save`` beside the
parameters and their name table (``static/io.py``'s files). A loaded
layer is an ``nn.Layer`` whose ``state_dict`` names are the saved
layer's and whose forward is differentiable (the flash ops carry their
registered autograd), so it can be fine-tuned. The format is the
port's own.

``TrainStep``: the JAX step traces forward, backward and the optimizer
update into one XLA program (a ``lax.scan`` of K steps with
``steps_per_call=K``); PyTorch runs eagerly, so here a call runs the K
steps in order and returns the K losses as one device tensor. Nothing
in a call reads a device value on the host, so the host queues the K
steps ahead of the device. ``loss_fn`` goes through the dy2static pass,
as the JAX step's does. A call mirrors the JAX step's order:

- one ``next_key()`` from the default threefry generator per call, with
  or without dropout; K > 1 splits it into K step keys
  (``split(key, K)``), and each step runs its loss under
  ``trace_key_scope`` of its key, so dropout draws the JAX step's keys;
- the learning rate is read once per call: the K steps share it;
- each step: the loss; with an enabled ``scaler``, ``scaler.scale(loss)
  .backward()`` and every gradient times ``1 / scale`` (in its dtype),
  with no inf check and no change of the scale (the JAX branch as it
  is: the check and the scale's update live in the eager
  ``GradScaler.step``); else ``loss.backward()``; then ``grad_clip``,
  the optimizer's update at the call's rate, and the gradients
  cleared.

Shardings are not ported; ``donate`` and ``compiler_options`` (XLA's)
are taken for the JAX signature and have nothing to act on here.
"""
from __future__ import annotations

import functools
import gc
import inspect
import types
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from ..core import random as _rng
from ..core import threefry
from ..core.tensor import CHECK_NAN_INF, as_tensor, to_tensor_arg
from . import dy2static as _d2s

__all__ = ["StaticFunction", "to_static", "not_to_static", "TrainStep",
           "save", "load", "TranslatedLayer"]


def _maybe_ast_convert(fn):
    """``fn`` through the dy2static AST pass (tensor-dependent
    ``if``/``while``/``for``); ``fn`` itself when its source is not
    available or the rewrite fails."""
    target = fn.__func__ if inspect.ismethod(fn) else fn
    if not _d2s.ast_transformable(target):
        return fn
    try:
        converted = _d2s.convert_to_static_ast(target)
    except Exception:  # noqa: BLE001 — trace-only fallback, as the JAX pass
        return fn
    if inspect.ismethod(fn):
        return types.MethodType(converted, fn.__self__)
    return converted


def _counters():
    """Every kernel launch counter of the port (name -> launches)."""
    from ..kernels import dropout as dk
    from ..kernels import flash_attention as fa
    from ..kernels import paged_attention as pa
    from ..utils.custom_op import LAUNCHES as op_launches

    return (fa.LAUNCHES, pa.LAUNCHES, dk.LAUNCHES, op_launches)


def _held_since(before):
    return [{k: v - old.get(k, 0) for k, v in c.items()
             if v != old.get(k, 0)} for c, old in zip(_counters(), before)]


class _Graph:
    __slots__ = ("graph", "inputs", "out", "ptrs", "held")

    def __init__(self, graph, inputs, out, ptrs, held):
        self.graph, self.inputs, self.out = graph, inputs, out
        self.ptrs, self.held = ptrs, held

    def replay(self):
        self.graph.replay()
        for c, d in zip(_counters(), self.held):
            for k, v in d.items():
                c[k] = c.get(k, 0) + v


# capture_report()'s reason while FLAGS_check_nan_inf is on
_CHECKING = ("FLAGS_check_nan_inf is on (the tensor checker): every op's "
             "outputs are checked on the host, which a graph's replay "
             "cannot do")


class _Signature:
    __slots__ = ("label", "graph", "reason", "calls", "replays", "captures")

    def __init__(self, label):
        self.label = label
        self.graph: Optional[_Graph] = None
        self.reason: Optional[str] = None
        self.calls = self.replays = self.captures = 0


def _is_static_leaf(x) -> bool:
    return isinstance(x, (bool, str)) or x is None or not isinstance(
        x, (int, float, torch.Tensor))


class StaticFunction:
    """``to_static`` of a function or a layer's forward (see the module
    docstring)."""

    def __init__(self, fn: Callable, layer=None):
        if layer is None and isinstance(getattr(fn, "__self__", None),
                                        torch.nn.Module):
            layer = fn.__self__
        self._layer = layer
        self._fn = _maybe_ast_convert(fn)
        self._signatures: Dict[tuple, _Signature] = {}
        functools.update_wrapper(self, fn)

    @property
    def forward(self):
        return self

    def _state(self):
        if self._layer is None:
            return []
        seen, out = set(), []
        for t in list(self._layer.parameters()) + list(
                self._layer.buffers()):
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def _split(self, args, kwargs, state):
        """``(flat, spec, traced positions, static key)``: tensors and
        numbers are traced (a number becomes a 0-d tensor, as the JAX
        ``StaticFunction`` makes every traced leaf an array); bools,
        strings, None and other objects are static."""
        flat, spec = pytree.tree_flatten((list(args), dict(kwargs)))
        like = next((x for x in flat if isinstance(x, torch.Tensor)),
                    state[0] if state else None)
        traced, static = [], []
        for i, leaf in enumerate(flat):
            if _is_static_leaf(leaf):
                try:
                    hash(leaf)
                    static.append((i, leaf))
                except TypeError:
                    static.append((i, id(leaf)))
                continue
            if not isinstance(leaf, torch.Tensor):
                flat[i] = to_tensor_arg(leaf) if like is None else as_tensor(
                    torch.tensor(leaf, device=like.device))
            traced.append(i)
        return flat, spec, traced, tuple(static)

    def _run(self, flat, spec, key):
        args, kwargs = pytree.tree_unflatten(flat, spec)
        with _rng.trace_key_scope(key), torch.no_grad():
            return self._fn(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        key = _rng.default_generator.next_key()
        state = self._state()
        flat, spec, traced, static = self._split(args, kwargs, state)
        tensors = [flat[i] for i in traced]
        sig_key = (spec, static, tuple(
            (tuple(t.shape), t.dtype, t.device) for t in tensors),
            getattr(self._layer, "training", None))
        sig = self._signatures.get(sig_key)
        if sig is None:
            sig = self._signatures[sig_key] = _Signature(", ".join(
                [f"{list(t.shape)} {str(t.dtype).replace('torch.', '')} "
                 f"{t.device}" for t in tensors]
                + [repr(v) for _, v in static]) or "()")
        sig.calls += 1
        devices = {t.device.type for t in tensors + state}
        if devices != {"cuda"}:
            sig.reason = sig.reason or (
                "runs on the CPU" if "cuda" not in devices else
                "takes a CPU tensor: its ops would run at capture, not at "
                "replay")
        if sig.calls == 1 or sig.reason is not None or CHECK_NAN_INF[0]:
            return self._run(flat, spec, key)
        ptrs = tuple(t.data_ptr() for t in state)
        if sig.graph is not None and sig.graph.ptrs != ptrs:
            sig.graph = None             # new storage: capture anew
        if sig.graph is None:
            sig.graph = self._capture(sig, flat, spec, traced, key, ptrs)
            if sig.graph is None:
                return self._run(flat, spec, key)
        else:
            for buf, t in zip(sig.graph.inputs, tensors):
                buf.copy_(t)
        sig.graph.replay()
        sig.replays += 1
        return pytree.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
            sig.graph.out)

    def _capture(self, sig, flat, spec, traced, key, ptrs):
        """The CUDA graph of ``sig`` over static copies of its inputs, or
        None with ``sig.reason`` set when the signature cannot be
        captured."""
        inputs = [flat[i].detach().clone() for i in traced]
        static_flat = list(flat)
        for i, buf in zip(traced, inputs):
            static_flat[i] = buf
        graph = torch.cuda.CUDAGraph()
        keys: list = []
        before = [dict(c) for c in _counters()]
        # no garbage collection while capturing: a collected graph would
        # be destroyed mid-capture, which invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        sig.captures += 1
        try:
            with torch.cuda.graph(graph):
                with _rng.record_keys(keys):
                    out = self._run(static_flat, spec, key)
        except _d2s.CaptureUnsupported as e:
            sig.reason = str(e)
        except RuntimeError as e:
            if "captur" not in str(e).lower():
                raise
            sig.reason = f"the capture failed: {e}"
        finally:
            if collecting:
                gc.enable()
        if sig.reason is None and keys:
            sig.reason = (f"draws {len(keys)} random key(s) (dropout): the "
                          "kernel takes its key from the host, so a graph "
                          "would replay one mask")
        if sig.reason is not None:
            torch.cuda.synchronize()        # surfaces a sticky CUDA error
            return None
        return _Graph(graph, inputs, out, ptrs, _held_since(before))

    def capture_report(self) -> Dict[str, dict]:
        """Per signature: ``captured`` (a graph replays it), ``reason``
        (why it runs eagerly, or None), ``calls``, ``captures`` and
        ``replays``."""
        checking = CHECK_NAN_INF[0]
        return {s.label: {"captured": s.graph is not None and not checking,
                          "reason": _CHECKING if checking else s.reason,
                          "calls": s.calls, "captures": s.captures,
                          "replays": s.replays}
                for s in self._signatures.values()}


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator / function mirroring ``paddle.jit.to_static``: a layer
    gets its ``forward`` wrapped (and is returned), a function becomes a
    :class:`StaticFunction`. ``input_spec``, ``build_strategy`` and
    ``backend`` are taken for the signature, as in the JAX package: the
    signatures come from the calls."""

    def deco(fn):
        if isinstance(fn, torch.nn.Module):
            if not isinstance(fn.forward, StaticFunction):
                fn.forward = StaticFunction(
                    fn.forward.__func__.__get__(fn), fn)
            return fn
        return StaticFunction(fn)

    if function is not None:
        return deco(function)
    return deco


def not_to_static(fn):
    fn._not_to_static = True
    return fn


class TrainStep:
    """``step = TrainStep(model, loss_fn, optimizer, steps_per_call=K)``
    then ``losses = step(x, y)``: ``loss_fn(model, x, y)`` returns the
    scalar loss. With ``K > 1`` every tensor argument has a leading
    ``[K]`` axis (step i takes index i) and the call returns the K
    losses ``[K]``; with ``K == 1`` the arguments are used as given and
    the call returns the loss."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 scaler=None, donate=True, in_shardings=None,
                 out_shardings=None, steps_per_call: int = 1,
                 compiler_options=None):
        if in_shardings is not None or out_shardings is not None:
            raise NotImplementedError("sharded train steps are not ported")
        self.steps_per_call = int(steps_per_call)
        if self.steps_per_call < 1:
            raise ValueError("steps_per_call must be >= 1")
        self.model = model
        # the loss goes through the dy2static pass, as the JAX step's
        self.loss_fn = _maybe_ast_convert(loss_fn)
        self.optimizer = optimizer
        self.scaler = scaler

    def _backward(self, loss) -> None:
        scaler = self.scaler
        if scaler is None or not scaler._enable:
            loss.backward()
            return
        scaler.scale(loss).backward()
        inv = 1.0 / scaler._scale
        by_dtype = defaultdict(list)
        for p in self.optimizer._params:
            if p.grad is not None:
                by_dtype[p.grad.dtype].append(p.grad)
        for dtype, grads in by_dtype.items():
            torch._foreach_mul_(grads, torch.tensor(inv, dtype=dtype).to(
                grads[0].device))

    def _step(self, key, lr, args, kwargs):
        opt = self.optimizer
        with _rng.trace_key_scope(key):
            loss = self.loss_fn(self.model, *args, **kwargs)
            self._backward(loss)
        with torch.no_grad():
            params_grads = [(p, p.grad) for p in opt._params
                            if p.grad is not None]
            if opt._grad_clip is not None:
                params_grads = opt._grad_clip(params_grads)
            opt._apply(params_grads, lr)
        opt.clear_grad()
        return loss.detach()

    def __call__(self, *args, **kwargs):
        K = self.steps_per_call
        key = _rng.default_generator.next_key()
        lr = self.optimizer.get_lr()
        if K == 1:
            loss = self._step(key, lr, args, kwargs)
            self.optimizer._global_step += 1
            return loss

        def at(x, i):
            return x[i] if isinstance(x, torch.Tensor) else x

        keys = threefry.split(key, K)
        losses = torch.stack([
            self._step(keys[i], lr, [at(a, i) for a in args],
                       {n: at(a, i) for n, a in kwargs.items()})
            for i in range(K)])
        self.optimizer._global_step += K
        return losses


# ------------------------------------------------------------- save/load ---


_JIT_FORMAT_VERSION = 2


def _forward_of(layer):
    """The layer's (or function's) forward through the dy2static pass,
    never a StaticFunction's graphs."""
    fwd = layer.forward if isinstance(layer, torch.nn.Module) else layer
    if isinstance(fwd, StaticFunction):
        return fwd._fn
    return _maybe_ast_convert(fwd)


def save(layer, path, input_spec=None, **configs):
    """``paddle.jit.save``: ``torch.export`` of the layer's forward with
    each ``None`` dim of ``input_spec`` symbolic (shared per axis), the
    parameters and buffers as inputs, written beside the parameters and
    their names (see the module docstring). Multi-output forwards are
    flattened; outputs are named ``out0..outN`` (or by ``output_spec``).
    The model should be in the mode it is to be loaded in (``eval()``
    for inference: the export keeps what the forward did)."""
    from ..static.io import export_artifact, symbolic_feed_specs, \
        write_artifact
    from ..static.program import InputSpec

    if input_spec is None:
        raise ValueError("jit.save requires input_spec (shapes to trace)")
    names, tensors = [], []
    if isinstance(layer, torch.nn.Module):
        for n, p in layer.named_parameters():
            names.append(n)
            tensors.append(p)
        for n, b in layer.named_buffers():
            if n not in names:
                names.append(n)
                tensors.append(b)
    fwd_callable = _forward_of(layer)

    def fwd(param_tensors, input_tensors):
        if not names:
            return pytree.tree_leaves(fwd_callable(*input_tensors))
        from torch.nn.utils.stateless import _reparametrize_module

        with _reparametrize_module(layer, dict(zip(names, param_tensors))):
            return pytree.tree_leaves(fwd_callable(*input_tensors))

    specs, feed_names = [], []
    for i, s in enumerate(input_spec):
        if isinstance(s, torch.Tensor):
            s = InputSpec.from_tensor(s)
        elif not isinstance(s, InputSpec):
            s = InputSpec.from_numpy(s)
        specs.append(s)
        feed_names.append(s.name or f"x{i}")
    device = tensors[0].device if tensors else None
    feed_specs = symbolic_feed_specs([(s.shape, s.dtype) for s in specs],
                                     device=device)
    exported = export_artifact(fwd, tensors, feed_specs)
    n_out = len(exported.graph_signature.user_outputs)
    fetch_names = [f"out{i}" for i in range(n_out)]
    out_spec = configs.pop("output_spec", None)
    if out_spec is not None:
        for i, s in enumerate(out_spec[:n_out]):
            nm = getattr(s, "name", None) or s
            if isinstance(nm, str):
                fetch_names[i] = nm
    if configs:
        raise TypeError(f"jit.save: unknown configs {sorted(configs)}")
    meta = {
        "format_version": _JIT_FORMAT_VERSION,
        "feed_names": feed_names,
        "fetch_names": fetch_names,
        "feed_dtypes": [str(s.dtype) for s in specs],
        "param_names": names,
        "n_params": len(tensors),
        "trainable": [bool(t.requires_grad) for t in tensors],
        "device": str(device or feed_specs[0][0].device),
    }
    write_artifact(path, meta, exported, tensors)


class TranslatedLayer(torch.nn.Module):
    """``paddle.jit.load``'s result: a layer over an exported program.
    Its parameters carry the saved layer's structured names (so
    ``state_dict`` keys round-trip); its forward runs the exported
    graph on them and differentiates through it, so a loaded model can
    be fine-tuned (the reference's ``translated_layer.py``)."""

    def __init__(self, meta, exported, params):
        super().__init__()
        from ..nn.layer.layers import Parameter

        self._meta = meta
        # not a submodule: its lifted constants are no state of the layer
        object.__setattr__(self, "_graph", exported.module())
        trainable = meta.get("trainable") or [True] * meta["n_params"]
        names = meta.get("param_names") or [
            f"p{i}" for i in range(meta["n_params"])]
        self._params_in_order = []
        for name, t, train in zip(names, params, trainable):
            p = Parameter(t, requires_grad=train)
            self._params_in_order.append(p)
            # the original dotted name, past register_parameter's check
            self._parameters[name] = p
        self._device = torch.device(meta["device"])

    def forward(self, *inputs):
        args = [to_tensor_arg(x) for x in inputs]
        args = [a.to(self._device) if isinstance(a, torch.Tensor) else a
                for a in args]
        out = self._graph(self._params_in_order, args)
        if isinstance(out, (list, tuple)) and len(out) == 1:
            return out[0]
        return tuple(out)


def load(path, **configs):
    """``paddle.jit.load``: a :class:`TranslatedLayer` over a ``jit.save``
    artifact (parameters on the device it was saved from). An artifact
    of ``static.save_inference_model`` loads with its parameters frozen,
    as in the JAX package."""
    from ..static.io import read_artifact

    meta, exported, params = read_artifact(path)
    if meta.get("format_version") == 1 and "trainable" not in meta:
        meta = dict(meta, trainable=[False] * meta["n_params"])
    return TranslatedLayer(meta, exported, params)
