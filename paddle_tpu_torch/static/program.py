"""Static-graph programs: record and replay at the torch level.

Counterpart of ``paddle_tpu/static/program.py`` (reference semantics:
``ProgramDesc`` / ``BlockDesc`` / ``VarDesc`` built by the Python
``Program`` / ``Block`` / ``Operator`` wrappers, run by
``InterpreterCore``). The JAX package routes every op whose inputs hold
a ``Variable`` through its dispatcher to ``static_apply``, which infers
the output shape with ``jax.eval_shape`` and appends an ``OpRecord``.
The port's ops are plain torch calls on a ``torch.Tensor`` subclass and
pass through no dispatcher, so it records at the torch level:

- a :class:`Variable` is a tensor subclass with no storage (a wrapper
  over a fake tensor of its program's ``FakeTensorMode``); every torch
  function or method given one reaches ``Variable.__torch_function__``;
- inside ``program_guard`` / ``enable_static`` a ``TorchFunctionMode``
  also records calls that take no ``Variable`` but a symbolic size (a
  factory such as ``torch.empty(B * S, ...)``); a call with grad enabled
  on a ``Parameter`` alone (``weight.t()`` in a forward) runs eagerly
  and its result keeps the call as a recipe, recorded when the result
  meets a Variable, so the parameter stays a live input of the program
  (initializers, loads and casts run under ``no_grad`` and keep none);
- the call runs on fake tensors (the InferMeta counterpart: outputs'
  shapes and dtypes, the flash kernels through their fake
  implementations) and is appended as an :class:`OpRecord` of the torch
  callable and its arguments; a function marked
  ``core.dispatch.recordable`` (a ``torch.autograd.Function`` with its
  own backward, a kernel that reads raw pointers, a host op) is recorded
  whole, shaped by its ``infer``.

An unknown (``None`` / ``-1``) dimension of ``data`` is a symbol of the
program's ``ShapeEnv``: ``Variable.shape`` reports it as ``-1`` on the
data variable, as the JAX ``Variable`` does, and as the symbolic size on
the results of ops, so code that reads an intermediate's shape
(``B, S, V = logits.shape``; ``reshape(B * S, V)``) records a size that
the replay evaluates from the feeds. Constants (tensors that are no
``Parameter``) are recorded by reference; parameters are read live at
every replay, so an in-place update (an optimizer step) is seen.

The Executor (``executor.py``) replays the records eagerly on the
program's device with torch's autograd for the backward; a CUDA graph
of a whole program is later work.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from ..core import dispatch as _dispatch
from ..core import dtypes as _dt
from ..core.device import current_device
from ..core.tensor import Tensor
from ..nn.layer import layers as _layers

__all__ = ["Variable", "OpRecord", "Block", "Program", "program_guard",
           "default_main_program", "default_startup_program", "data",
           "InputSpec", "enable_static", "disable_static", "in_static_mode",
           "in_dynamic_mode", "run_ops", "prune_ops",
           "register_test_mode_rewrite", "VAR", "PARAM", "CONST"]

_state = threading.local()
# the hint of an unknown dimension while recording (any size but 0 and 1,
# which a ShapeEnv specializes)
_UNKNOWN_HINT = 2


# ------------------------------------------------------------------ mode ---


def _mode_stack():
    if not hasattr(_state, "static_mode"):
        _state.static_mode = [False]
    return _state.static_mode


class _Recorder(TorchFunctionMode):
    """Records calls that take a symbolic size (``Variable.__torch_function__``
    records the calls that take a Variable); runs a forward's calls on
    parameters alone eagerly and keeps each result's recipe
    (:func:`_defer`); passes every other call through."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(_state, "replaying", False):
            return func(*args, **kwargs)
        if _symbolic_input(args, kwargs):
            return _record(func, args, kwargs)
        out = func(*args, **kwargs)
        if _deferred_input(func, args, kwargs):
            _defer(func, args, kwargs, out)
        return out


def _push_recorder():
    mode = _Recorder()
    mode.__enter__()
    _stack("recorders").append(mode)


def _pop_recorder():
    _state.recorders.pop().__exit__(None, None, None)


def _stack(name):
    if not hasattr(_state, name):
        setattr(_state, name, [])
    return getattr(_state, name)


def enable_static():
    if not _mode_stack()[-1]:
        _push_recorder()
    _mode_stack()[-1] = True


def disable_static():
    if _mode_stack()[-1] and _stack("recorders"):
        _pop_recorder()
    _mode_stack()[-1] = False


def in_static_mode() -> bool:
    return _mode_stack()[-1]


def in_dynamic_mode() -> bool:
    return not in_static_mode()


# ------------------------------------------------------------- Variable ----


class Variable(Tensor):
    """A symbolic node of a Program: a tensor subclass with no storage
    over ``_fake``, a fake tensor of the program's ``FakeTensorMode``.
    ``shape`` is a list; ``desc_shape`` the declared one (``-1``
    unknown)."""

    _symbolic = True

    @staticmethod
    def __new__(cls, block, fake, name, source, desc_shape=None,
                stop_gradient=True):
        v = torch.Tensor._make_wrapper_subclass(
            cls, fake.shape, strides=fake.stride(), dtype=fake.dtype,
            device=fake.device, requires_grad=False)
        v._fake = fake
        v.block = block
        v._name = name
        v.source = source        # "data" | "op" | "grad"
        v.persistable = False
        v._stop_gradient = stop_gradient
        v.desc_shape = (list(desc_shape) if desc_shape is not None else
                        [d if isinstance(d, int) else -1 for d in fake.shape])
        return v

    def __init__(self, *args, **kwargs):
        pass

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(_state, "replaying", False):
            raise RuntimeError(f"a Variable reached {_op_name(func)} while a "
                               "program replays (a missing feed?)")
        return _record(func, args, kwargs)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        # every call stops at __torch_function__; none reaches a kernel
        raise RuntimeError(f"{func} reached a symbolic Variable's data")

    @property
    def name(self):
        return self._name

    @property
    def program(self) -> "Program":
        return self.block.program

    @property
    def shape(self):
        """Static dims as ints; an unknown dim ``-1`` on a data variable
        (the JAX ``Variable``'s report) and its symbolic size on the
        result of an op."""
        if self.source == "data":
            return list(self.desc_shape)
        return list(self._fake.shape)

    @property
    def ndim(self):
        return self._fake.dim()

    @property
    def dtype(self):
        return self._fake.dtype

    @property
    def stop_gradient(self):
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, value):
        self._stop_gradient = bool(value)

    def numpy(self):
        raise RuntimeError(
            f"Variable '{self.name}' is symbolic; run it through "
            "paddle.static.Executor to get a value")

    def backward(self, *a, **k):
        raise RuntimeError("Variables have no eager backward; use "
                           "paddle.static.append_backward")

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, source={self.source})")

    __str__ = __repr__


# Input reference kinds of an OpRecord (the JAX package's)
VAR, PARAM, CONST = "var", "param", "const"

# op name -> (record -> test-mode callable): how clone(for_test=True)
# rewrites a train-only op (the reference's is_test flip)
_TEST_MODE_REWRITES: dict = {}


def register_test_mode_rewrite(op_name: str, rewriter) -> None:
    _TEST_MODE_REWRITES[op_name] = rewriter


def _op_name(func) -> str:
    name = getattr(func, "__name__", None) or str(func)
    return name.split(".")[-1]


class OpRecord:
    """One recorded call: ``func(*args, **kwargs)`` where the arguments
    hold Variables, parameters, constants and symbolic sizes; its tensor
    outputs are ``outputs`` (the leaves of ``out_spec`` at
    ``out_slots``). An op that mutates its first argument and returns
    None lists that Variable as its output."""

    __slots__ = ("op_name", "func", "args", "kwargs", "out_spec",
                 "out_slots", "outputs", "inputs")

    def __init__(self, op_name, func, args, kwargs, out_spec, out_slots,
                 outputs):
        self.op_name = op_name
        self.func = func
        self.args = args
        self.kwargs = kwargs
        self.out_spec = out_spec
        self.out_slots = out_slots
        self.outputs = outputs
        inputs = []
        for leaf in _leaves((args, kwargs)):
            if isinstance(leaf, Variable):
                inputs.append((VAR, leaf))
            elif isinstance(leaf, torch.nn.Parameter):
                inputs.append((PARAM, leaf))
            elif isinstance(leaf, torch.Tensor):
                inputs.append((CONST, leaf))
        self.inputs = inputs

    @property
    def type(self):  # reference OpDesc.type() parity
        return self.op_name

    @property
    def fn(self):
        return self.func

    def input_names(self):
        out = []
        for kind, payload in self.inputs:
            if kind == VAR:
                out.append(payload.name)
            elif kind == PARAM:
                out.append(getattr(payload, "name", None)
                           or f"param_{id(payload)}")
        return out

    def output_names(self):
        return [v.name for v in self.outputs]

    def with_func(self, op_name, func):
        return OpRecord(op_name, func, self.args, self.kwargs, self.out_spec,
                        self.out_slots, self.outputs)

    def __repr__(self):
        return (f"OpRecord({self.op_name}: "
                f"{self.input_names()} -> {self.output_names()})")


def _leaves(tree):
    """Every leaf of nested lists, tuples (``torch.Size`` too) and
    dicts."""
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, torch.Size):
        return torch.Size([fn(x) for x in tree])
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, x) for x in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


_SYM = (torch.SymInt, torch.SymFloat, torch.SymBool)


def _symbolic_input(args, kwargs) -> bool:
    return any(isinstance(x, (Variable,) + _SYM)
               for x in _leaves((args, kwargs)))


def _has_recipe(x) -> bool:
    return isinstance(x, torch.Tensor) and (
        isinstance(x, torch.nn.Parameter) or hasattr(x, "_static_recipe"))


def _deferred_input(func, args, kwargs) -> bool:
    """A forward's call (grad on: not an initializer, a load or a cast
    under ``no_grad``) on a Parameter or on what such a call made."""
    name = getattr(func, "__name__", "")
    if (not torch.is_grad_enabled() or name in _PARAM_PASSTHROUGH
            or name.endswith("_") and not name.endswith("__")):
        return False
    return any(_has_recipe(x) for x in _leaves((args, kwargs)))


# a Parameter's attribute reads and writes (``requires_grad``,
# ``p.data = ...``) and in-place calls (an in-place op on a leaf that
# requires grad is no forward: a load or a cast) run as they are
_PARAM_PASSTHROUGH = {"__get__", "__set__", "__delete__", "data_ptr",
                      "untyped_storage", "register_hook", "retain_grad"}


def _defer(func, args, kwargs, out) -> None:
    """Each tensor ``func`` made from parameters keeps its recipe: used
    eagerly it is the value; reaching a recorded op (``weight.t()`` into
    a linear on a Variable, a cast under ``auto_cast``) it is recorded
    there first, so the parameter stays a live input of the program."""
    for i, leaf in enumerate(pytree.tree_leaves(out)):
        if isinstance(leaf, torch.Tensor) and not isinstance(
                leaf, torch.nn.Parameter):
            leaf._static_recipe = (func, args, kwargs, i)


def _materialize(prog: "Program", x):
    """The Variable of a parameter-made tensor ``x`` in ``prog``: its
    recipe recorded (once per program)."""
    made = x.__dict__.setdefault("_static_vars", {})
    if id(prog) not in made:
        func, args, kwargs, slot = x._static_recipe
        made[id(prog)] = pytree.tree_leaves(_record(func, args, kwargs))[slot]
    return made[id(prog)]


class Block:
    """The single global block (control flow is recorded inline, not as
    sub-blocks)."""

    def __init__(self, program: "Program", idx: int = 0):
        self.program = program
        self.idx = idx
        self.ops: List[OpRecord] = []
        self.vars: Dict[str, Variable] = {}

    def var(self, name: str) -> Variable:
        if name not in self.vars:
            raise ValueError(f"Variable {name!r} not found in block")
        return self.vars[name]

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def create_var(self, name=None, shape=None, dtype="float32",
                   stop_gradient=True, **kw) -> Variable:
        name = name or self.program._unique_name("tmp")
        v = self.program._variable(shape or [], dtype, name, "op",
                                   stop_gradient)
        self.vars[name] = v
        return v

    def all_parameters(self):
        return self.program.all_parameters()


class Program:
    """Recorded op list + symbol table. Acts as the reference Program and
    its global Block. Owns the ``FakeTensorMode`` (and ``ShapeEnv``) its
    Variables live in."""

    def __init__(self):
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.fx.experimental.symbolic_shapes import ShapeEnv

        self._block = Block(self)
        self._data_vars: List[Variable] = []
        self._name_counter: Dict[str, int] = {}
        self._version = 0
        self._backward: Optional[Tuple[Variable, list]] = None
        self._opt = None  # (optimizer, params_grads)
        # startup semantics: the parameters made while this program was
        # the startup program, their initial values taken at the first
        # ``exe.run(startup)`` and restored at every later one
        self._startup_params: List[torch.nn.Parameter] = []
        self._startup_values: Optional[List[torch.Tensor]] = None
        self.random_seed = None
        self._shape_env = ShapeEnv(duck_shape=False)
        self._fake_mode = FakeTensorMode(shape_env=self._shape_env,
                                         allow_non_fake_inputs=True)

    # ------------------------------------------------------------ naming --
    def _unique_name(self, base: str) -> str:
        n = self._name_counter.get(base, 0)
        self._name_counter[base] = n + 1
        return f"{base}_{n}" if n else base

    # ------------------------------------------------------- variables --
    def _variable(self, shape, dtype, name, source, stop_gradient=True,
                  device=None):
        """A Variable of declared ``shape`` (``None`` / ``-1`` unknown: a
        fresh symbol) on ``device`` (default: the current device)."""
        from torch.fx.experimental.symbolic_shapes import (
            DimDynamic, StatelessSymbolicContext)

        decl = [-1 if s is None or int(s) < 0 else int(s) for s in shape]
        base = torch.empty([_UNKNOWN_HINT if d == -1 else d for d in decl],
                           dtype=_dt.convert_dtype(dtype),
                           device=device or current_device())
        ctx = StatelessSymbolicContext(dynamic_sizes=[
            DimDynamic.DYNAMIC if d == -1 else DimDynamic.STATIC
            for d in decl])
        fake = self._fake_mode.from_tensor(base, symbolic_context=ctx)
        return Variable(self._block, fake, name, source, decl, stop_gradient)

    def _fake_of(self, t: torch.Tensor):
        """A fake tensor with ``t``'s shape, strides, dtype and device
        (what shape inference needs of a parameter or a constant)."""
        with torch._C.DisableTorchFunctionSubclass(), self._fake_mode:
            return torch.empty_strided(tuple(t.shape), t.stride(),
                                       dtype=t.dtype, device=t.device)

    # ------------------------------------------------------------ blocks --
    def global_block(self) -> Block:
        return self._block

    def block(self, idx: int) -> Block:
        if idx != 0:
            raise IndexError("single-block programs (control flow is "
                             "recorded inline)")
        return self._block

    @property
    def num_blocks(self):
        return 1

    def current_block(self) -> Block:
        return self._block

    @property
    def blocks(self):
        return [self._block]

    # ----------------------------------------------------------- recording --
    def _append_op(self, rec: OpRecord):
        self._block.ops.append(rec)
        for v in rec.outputs:
            self._block.vars[v.name] = v
        self._version += 1

    @property
    def ops(self):
        return self._block.ops

    def list_vars(self):
        return list(self._block.vars.values())

    def all_parameters(self):
        """Unique Parameters referenced by recorded ops, in first-use
        order."""
        seen, out = set(), []
        for rec in self._block.ops:
            for kind, payload in rec.inputs:
                if kind == PARAM and id(payload) not in seen:
                    seen.add(id(payload))
                    out.append(payload)
        return out

    @property
    def _startup_inits(self):
        """``(param, value)`` pairs of the startup program (the JAX
        attribute; a value is None until the first run)."""
        vals = self._startup_values or [None] * len(self._startup_params)
        return list(zip(self._startup_params, vals))

    # -------------------------------------------------------------- clone --
    def clone(self, for_test: bool = False) -> "Program":
        p = Program.__new__(Program)
        p._block = Block(p)
        p._block.ops = list(self._block.ops)
        p._block.vars = dict(self._block.vars)
        p._data_vars = list(self._data_vars)
        p._name_counter = dict(self._name_counter)
        p._version = self._version
        p._startup_params = list(self._startup_params)
        p._startup_values = self._startup_values
        p.random_seed = self.random_seed
        p._shape_env = self._shape_env
        p._fake_mode = self._fake_mode
        if for_test:
            p._backward = None
            p._opt = None
            # the reference flips every op to is_test; here a train-only
            # op registered a test-mode rewrite (dropout -> identity or a
            # scale). Records are replaced in the CLONE only.
            p._block.ops = [
                rec.with_func(rec.op_name + "@test",
                              _TEST_MODE_REWRITES[rec.op_name](rec))
                if rec.op_name in _TEST_MODE_REWRITES else rec
                for rec in p._block.ops]
        else:
            p._backward = self._backward
            p._opt = self._opt
        return p

    def __repr__(self):
        lines = [f"Program(ops={len(self._block.ops)}, "
                 f"data={[v.name for v in self._data_vars]})"]
        for rec in self._block.ops[:50]:
            lines.append(f"  {rec}")
        if len(self._block.ops) > 50:
            lines.append(f"  ... {len(self._block.ops) - 50} more")
        return "\n".join(lines)


# --------------------------------------------------------- default programs --


def _prog_stack():
    if not hasattr(_state, "programs"):
        _state.programs = [(Program(), Program())]  # (main, startup)
    return _state.programs


def default_main_program() -> Program:
    return _prog_stack()[-1][0]


def default_startup_program() -> Program:
    return _prog_stack()[-1][1]


class program_guard:
    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self._main = main_program
        self._startup = startup_program or Program()

    def __enter__(self):
        _prog_stack().append((self._main, self._startup))
        _mode_stack().append(True)
        _push_recorder()
        return self._main

    def __exit__(self, *exc):
        _pop_recorder()
        _prog_stack().pop()
        _mode_stack().pop()
        return False


def _on_new_parameter(param) -> None:
    """A Parameter made in static mode joins the current startup
    program (its value is read at the first ``exe.run(startup)``)."""
    if in_static_mode():
        default_startup_program()._startup_params.append(param)


_layers.set_parameter_hook(_on_new_parameter)


# ------------------------------------------------------------------- data ---


def data(name: str, shape: Sequence[int], dtype=None, lod_level=0
         ) -> Variable:
    """Declare a feed target (reference ``paddle.static.data``) on the
    current device."""
    prog = default_main_program()
    dtype = dtype or _dt.get_default_dtype()
    v = prog._variable(shape, dtype, name, "data")
    prog.global_block().vars[name] = v
    prog._data_vars.append(v)
    return v


class InputSpec:
    """Shape/dtype spec for ``jit.save`` (reference
    ``python/paddle/static/input.py``); an unknown dim is ``None``."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = [s if s is not None and int(s) >= 0 else None
                      for s in shape]
        self.dtype = _dt.convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(list(tensor.shape), tensor.dtype,
                   name or getattr(tensor, "name", None))

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(list(ndarray.shape), str(ndarray.dtype), name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


# --------------------------------------------------------------- recorder ---


def _owning_program(args, kwargs) -> Program:
    """The program of the Variables among the inputs. clone() shares
    Variable objects between programs, so ownership is decided by
    membership: a Variable present in the current default program
    records there."""
    cur = default_main_program()
    prog = None
    for x in _leaves((args, kwargs)):
        if not isinstance(x, Variable):
            continue
        owner = cur if cur._block.vars.get(x.name) is x else x.program
        if prog is None:
            prog = owner
        elif owner is not prog:
            raise ValueError("op inputs come from different Programs")
    return prog if prog is not None else cur


def _to_fake(prog: Program, x):
    if isinstance(x, Variable):
        return x._fake
    if isinstance(x, torch.Tensor):
        from torch._subclasses.fake_tensor import FakeTensor

        if isinstance(x, FakeTensor):
            return x
        return prog._fake_of(x)
    return x


def _record(func, args, kwargs, name=None, infer=None):
    """Run ``func`` (or ``infer``) on fake tensors and append the call to
    its program; return its outputs as Variables (a parameter-made
    input recorded first, :func:`_materialize`)."""
    from torch._subclasses.fake_tensor import FakeTensor

    if any(hasattr(x, "_static_recipe") for x in _leaves((args, kwargs))
           if isinstance(x, torch.Tensor)):
        prog = _owning_program(args, kwargs)
        swap = (lambda x: _materialize(prog, x)
                if hasattr(x, "_static_recipe") else x)
        args, kwargs = _map(swap, args), _map(swap, kwargs)

    prog = _owning_program(args, kwargs)
    fargs = _map(lambda x: _to_fake(prog, x), args)
    fkwargs = _map(lambda x: _to_fake(prog, x), kwargs)
    shape_fn = infer if infer is not None else func
    try:
        # the recorder stays out of the inference: a function recorded
        # whole may call factories of symbolic sizes on the fakes
        with torch._C.DisableTorchFunctionSubclass(), prog._fake_mode, \
                torch.no_grad(), replaying():
            out = shape_fn(*fargs, **fkwargs)
    except Exception as e:  # noqa: BLE001 — re-raised with the op's name
        raise RuntimeError(
            f"shape inference failed for {name or _op_name(func)!r} in "
            f"static mode: {e}") from e
    by_fake = {id(v._fake): v for v in _leaves((args, kwargs))
               if isinstance(v, Variable)}
    flat, spec = pytree.tree_flatten(out)
    slots, outputs = [], []
    base = name or _op_name(func)
    for i, leaf in enumerate(flat):
        if not isinstance(leaf, FakeTensor):
            continue
        var = by_fake.get(id(leaf))
        if var is None:
            var = Variable(prog.global_block(), leaf,
                           prog._unique_name(base), "op")
        flat[i] = var
        slots.append(i)
        outputs.append(var)
    if out is None and args and isinstance(args[0], Variable):
        outputs = [args[0]]          # mutated in place (e.g. __setitem__)
    elif not outputs:
        return out                   # a size, a dtype, a flag
    prog._append_op(OpRecord(base, func, args, kwargs, spec, slots, outputs))
    return None if out is None else pytree.tree_unflatten(flat, spec)


def _record_hook(name, fn, args, kwargs, infer):
    return _record(fn, args, kwargs, name=name, infer=infer)


_dispatch.set_recorder(_record_hook)


# ----------------------------------------------------------------- replay ---


def _sym_eval(expr, bind):
    """A sympy size expression of the recorder's symbols, evaluated with
    ``bind`` (symbol -> int, or a SymInt under ``torch.export``)."""
    import sympy

    from torch.utils._sympy import functions as sf

    if expr.is_Integer:
        return int(expr)
    if expr.is_Number:
        return float(expr)
    if expr.is_Symbol:
        if expr not in bind:
            raise RuntimeError(f"size {expr} is bound by no feed")
        return bind[expr]
    args = [_sym_eval(a, bind) for a in expr.args]
    if isinstance(expr, sympy.Add):
        out = args[0]
        for a in args[1:]:
            out = out + a
        return out
    if isinstance(expr, sympy.Mul):
        out = args[0]
        for a in args[1:]:
            out = out * a
        return out
    if isinstance(expr, sympy.Pow):
        return args[0] ** args[1]
    if isinstance(expr, sf.FloorDiv):
        return args[0] // args[1]
    if isinstance(expr, (sf.Mod, sf.PythonMod, sympy.Mod)):
        return args[0] % args[1]
    if isinstance(expr, sf.CleanDiv):
        return args[0] // args[1]
    if isinstance(expr, (sympy.Max, getattr(sf, "Max", sympy.Max))):
        return max(args)
    if isinstance(expr, (sympy.Min, getattr(sf, "Min", sympy.Min))):
        return min(args)
    raise NotImplementedError(f"size expression {expr!r}")


class _Bindings:
    """The recorder's size symbols bound to one run's sizes: each
    symbolic dim of a data variable to the size of its feed (an int, or
    a SymInt under ``torch.export``)."""

    def __init__(self, program: Program, feeds: Dict[int, Any]):
        self._env = program._shape_env
        self._bind = {}
        for var in program._data_vars:
            t = feeds.get(id(var))
            if t is None:
                continue
            for d, size in enumerate(var._fake.shape):
                if isinstance(size, torch.SymInt):
                    self._bind.setdefault(size.node.expr, t.shape[d])

    def __call__(self, x):
        if isinstance(x, _SYM):
            val = _sym_eval(self._env.replace(x.node.expr), self._bind)
            return bool(val) if isinstance(x, torch.SymBool) else val
        return x


def bind_feeds(program: Program, env: Dict[int, Any]) -> _Bindings:
    """Bindings of the program's size symbols from the data variables
    in ``env`` (keyed by ``id(Variable)``)."""
    return _Bindings(program, env)


class replaying:
    """Inside, Variables refuse every op and the recorder records
    nothing (a replay runs on concrete tensors only)."""

    def __enter__(self):
        self._prev = getattr(_state, "replaying", False)
        _state.replaying = True
        return self

    def __exit__(self, *exc):
        _state.replaying = self._prev
        return False


def run_ops(ops: List[OpRecord], env: Dict[int, Any], bind,
            param_lookup=None) -> Dict[int, Any]:
    """Replay op records into ``env`` (keyed by ``id(Variable)``);
    ``bind`` evaluates symbolic sizes, ``param_lookup`` (default: the
    live parameter) resolves a parameter. Shared by the Executor and the
    exporters, so their interpreter semantics cannot diverge."""

    def resolve(x):
        if isinstance(x, Variable):
            if id(x) not in env:
                raise RuntimeError(f"input {x.name!r} has no value — missing "
                                   "feed?")
            return env[id(x)]
        if param_lookup is not None and isinstance(x, torch.nn.Parameter):
            return param_lookup(x)
        return bind(x)

    with replaying():
        for rec in ops:
            out = rec.func(*_map(resolve, rec.args),
                           **_map(resolve, rec.kwargs))
            if out is None:
                continue
            flat = pytree.tree_leaves(out) if rec.out_spec is not None \
                else [out]
            for slot, var in zip(rec.out_slots, rec.outputs):
                env[id(var)] = flat[slot]
    return env


def prune_ops(program: Program, target_vars) -> List[OpRecord]:
    """Backward slice: the op records needed to compute ``target_vars``
    (the reference's ``framework/prune.cc``)."""
    needed = {id(v) for v in target_vars if isinstance(v, Variable)}
    keep = []
    for rec in reversed(program.ops):
        if any(id(o) in needed for o in rec.outputs):
            keep.append(rec)
            for kind, payload in rec.inputs:
                if kind == VAR:
                    needed.add(id(payload))
    keep.reverse()
    return keep


def _dropout_test_rewrite(rec):
    """``clone(for_test=True)`` of a recorded dropout (the reference's
    is_test flip): ``upscale_in_train`` is the identity at inference,
    ``downscale_in_infer`` scales by ``1 - p`` in x's dtype."""
    args = list(rec.args) + [None] * 5
    p = rec.kwargs.get("p", args[2])
    upscale = rec.kwargs.get("upscale", args[4] if args[4] is not None
                             else True)
    if upscale:
        return lambda x, *a, **k: x
    return lambda x, *a, **k: x * torch.tensor(1.0 - p, dtype=x.dtype)


register_test_mode_rewrite("dropout", _dropout_test_rewrite)
