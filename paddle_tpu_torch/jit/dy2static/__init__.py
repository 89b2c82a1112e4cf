"""dy2static: AST transforms for data-dependent Python control flow.

Counterpart of ``paddle_tpu/jit/dy2static/__init__.py`` (reference:
``python/paddle/jit/dy2static/``, ``ast_transformer.py`` and its
transformers rewrite ``if``/``while``/``for`` into ``convert_ifelse`` /
``convert_while_loop`` calls from ``convert_operators.py``). The AST
pass is the JAX package's, copied: it is plain Python. The runtime
helpers differ in what "traced" means. In the JAX package it is a jax
Tracer; here a value is traced when it is a tensor that holds no data
or may not be read on the host:

- a fake tensor (``torch.export`` traces on them) or a meta tensor (the
  static recorder's ``Variable``, ``paddle_tpu_torch.static``);
- a CUDA tensor while the current stream captures a CUDA graph
  (``jit.to_static``'s replayed signatures).

With a concrete predicate every helper runs plain Python, bit for bit
the eager function. With a traced one:

- ``if``: both branches run and :func:`_select` picks leaf-wise with
  ``torch.where`` (capturable, exportable and recordable);
- ``while`` (and a ``for`` over a traced ``range``): under
  ``torch.export`` the loop state goes through
  ``torch._higher_order_ops.while_loop``; under CUDA-graph capture the
  loop reads its predicate on the host every iteration, which a graph
  cannot hold, so it raises :class:`CaptureUnsupported` (the caller,
  ``StaticFunction``, runs that signature eagerly and says why); on a
  static ``Variable`` it raises (use ``paddle.jit.to_static``);
- ``print`` and ``assert`` of a traced value: under capture they raise
  :class:`CaptureUnsupported` (a host read); under export or recording
  ``print`` prints the symbolic value at trace time and ``assert`` is
  not checked.

Branch and body code stays in place, mutating the enclosing locals
through ``nonlocal`` (Paddle's scheme); state snapshot and restore do
the functionalization.
"""
from __future__ import annotations

import ast
import functools
import inspect
import sys
import textwrap
import weakref
from typing import Callable, List, Set

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

__all__ = ["convert_to_static_ast", "convert_ifelse", "convert_while_loop",
           "convert_for", "UNDEFINED", "ast_transformable",
           "CaptureUnsupported", "is_traced", "ProgramTranslator"]


class CaptureUnsupported(RuntimeError):
    """Raised inside a CUDA-graph capture by a helper that would read a
    device value on the host (a tensor-predicate ``while``, a traced
    ``print`` or ``assert``, a host op). ``StaticFunction`` catches it,
    drops the partial graph and runs the signature eagerly."""


class _Undefined:
    """Placeholder for names not yet bound on some path (reference
    ``UndefinedVar``). Using it as a Tensor raises naturally."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "UNDEFINED"


UNDEFINED = _Undefined()


def _is_symbolic(t: torch.Tensor) -> bool:
    """A tensor that holds no data: meta (the static recorder's
    ``Variable``) or fake (``torch.export``)."""
    if getattr(type(t), "_symbolic", False) or t.is_meta:
        return True
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def capturing(t=None) -> bool:
    """True while the current CUDA stream captures a graph (``t``, when
    given, must be a CUDA tensor: a CPU value is concrete under
    capture)."""
    if t is not None and not (isinstance(t, torch.Tensor) and t.is_cuda):
        return False
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def is_traced(x) -> bool:
    """A value the host may not read: a symbolic tensor, or a CUDA
    tensor under CUDA-graph capture."""
    if not isinstance(x, torch.Tensor):
        return False
    return _is_symbolic(x) or capturing(x)


def _host_read(what: str):
    """Refuse a host read of a traced value: inside a capture it raises
    :class:`CaptureUnsupported`."""
    raise CaptureUnsupported(f"dy2static: {what} reads a device value on "
                             "the host, which a CUDA graph cannot capture")


def _to_bool(x) -> bool:
    return bool(x)


def _scalar_pred(pred) -> torch.Tensor:
    """A traced one-element predicate as a 0-d bool tensor."""
    if pred.numel() != 1:
        # eager raises the ambiguous-truth-value error here; a silent
        # elementwise select would change output shapes vs eager
        raise ValueError(
            "dy2static: `if` condition is a traced tensor with "
            f"{pred.numel()} elements; reduce it to a scalar "
            "(e.g. .any()/.all())")
    pred = pred.reshape(())
    return pred if pred.dtype == torch.bool else pred != 0


def _full_like(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of a Python scalar on ``like``'s device, filled on
    the device (no host-to-device copy inside a capture)."""
    return torch.full((), value, device=like.device)


def _select(pred, t_state, f_state):
    """Leaf-wise select between two state tuples (shapes must match on
    every path that is actually used downstream)."""
    out = []
    for tv, fv in zip(t_state, f_state):
        if tv is UNDEFINED and fv is UNDEFINED:
            out.append(UNDEFINED)
            continue
        if tv is UNDEFINED or fv is UNDEFINED:
            # defined on one path only: keep the defined one (using it when
            # the other path was taken is a user error surfaced at use)
            out.append(tv if fv is UNDEFINED else fv)
            continue
        if (isinstance(tv, (tuple, list)) and type(tv) is type(fv)
                and len(tv) == len(fv)):
            # container state (e.g. a tuple-valued early return):
            # select leaf-wise — comparing the containers below would
            # bool() elementwise Tensor equality
            sel = _select(pred, list(tv), list(fv))
            make = getattr(type(tv), "_make", None)  # namedtuple
            out.append(make(sel) if make else type(tv)(sel))
            continue
        if (isinstance(tv, (tuple, list)) and isinstance(fv, (tuple, list))
                and any(isinstance(l, torch.Tensor)
                        for l in list(tv) + list(fv))):
            raise ValueError(
                "dy2static: tensor-bearing containers of different "
                f"shape/length diverge across a traced-condition branch "
                f"({len(tv)} vs {len(fv)} elements); both paths must "
                "produce the same structure (e.g. matching return arity)")
        if (isinstance(tv, dict) and isinstance(fv, dict)
                and tv.keys() == fv.keys()):
            keys = list(tv)
            sel = _select(pred, [tv[k] for k in keys],
                          [fv[k] for k in keys])
            out.append(dict(zip(keys, sel)))
            continue
        if isinstance(tv, torch.Tensor) or isinstance(fv, torch.Tensor):
            # torch.where records on the tape (and in a static program)
            tt = tv if isinstance(tv, torch.Tensor) else _full_like(tv, pred)
            ft = fv if isinstance(fv, torch.Tensor) else _full_like(fv, pred)
            out.append(torch.where(pred, tt, ft))
            continue
        if tv is not fv and tv != fv:
            if isinstance(tv, (bool, int, float)) and isinstance(
                    fv, (bool, int, float)):
                # flow flags (and other scalar state) diverging under
                # a traced predicate: lift to a traced select
                out.append(torch.where(pred, _full_like(tv, pred),
                                       _full_like(fv, pred)))
                continue
            raise ValueError(
                "dy2static: a non-tensor variable diverges across a "
                f"traced-condition branch ({tv!r} vs {fv!r}); only "
                "tensor/scalar state can depend on a traced predicate")
        out.append(tv)
    return out


def convert_ifelse(pred, true_fn: Callable, false_fn: Callable,
                   get_args: Callable, set_args: Callable):
    """Runtime for a rewritten ``if`` (reference
    ``convert_operators.py::convert_ifelse``)."""
    if not is_traced(pred):
        (true_fn if _to_bool(pred) else false_fn)()
        return
    pred = _scalar_pred(pred)
    saved = get_args()
    true_fn()
    t_state = get_args()
    set_args(saved)
    false_fn()
    f_state = get_args()
    set_args(_select(pred, t_state, f_state))


def _carry_leaves(v, like):
    """``v``'s pytree with Python scalars as 0-d tensors on ``like``'s
    device: ``(leaves, spec)``."""
    leaves, spec = pytree.tree_flatten(v)
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif isinstance(leaf, (bool, int, float)):
            out.append(_full_like(leaf, like))
        else:
            return None, None
    return out, spec


def _while_export(cond_fn, body_fn, get_args, set_args, first):
    """A tensor-predicate loop under ``torch.export``: the live state
    (tensors; Python scalars become 0-d tensors, as JAX's carry makes
    them arrays) rides ``torch._higher_order_ops.while_loop``."""
    # the operator itself: the public ``while_loop`` first traces its
    # functions with dynamo, which refuses the nonlocal writes of the
    # rewritten body; the operator traces them as Python under export
    from torch._higher_order_ops.while_loop import while_loop_op

    init_all = get_args()
    undef = [i for i, v in enumerate(init_all) if v is UNDEFINED]
    if undef:
        # names unbound at entry but assigned in the body (e.g. the
        # return transformer's __jst_ret) must ride the carry: run the
        # body once to learn each one's structure, carry zeros of it
        # (dead unless the loop never takes the defining path), and
        # restore the entry state
        set_args(list(init_all))
        body_fn()
        after = get_args()
        for i in undef:
            leaves, spec = (None, None) if after[i] is UNDEFINED else \
                _carry_leaves(after[i], first)
            if leaves is not None:
                init_all[i] = pytree.tree_unflatten(
                    [torch.zeros_like(l) for l in leaves], spec)
        set_args(list(init_all))
    live, specs, flat = [], [], []
    for i, v in enumerate(init_all):
        if v is UNDEFINED:
            continue
        leaves, spec = _carry_leaves(v, first)
        if leaves is None:
            continue        # strings / objects: per-iteration temps
        live.append(i)
        specs.append((len(leaves), spec))
        # a constant made before the loop (``to_tensor(0)``) enters the
        # carry as a traced copy
        flat.extend(l if _is_symbolic(l) else l.clone() for l in leaves)

    def scatter(vals):
        full = list(init_all)
        pos = 0
        for i, (n, spec) in zip(live, specs):
            full[i] = pytree.tree_unflatten(list(vals[pos:pos + n]), spec)
            pos += n
        return full

    def carried_out():
        cur = get_args()
        out = []
        for i, (n, _) in zip(live, specs):
            leaves, _ = _carry_leaves(cur[i], first)
            out.extend(leaves)
        return out

    # tensors of the enclosing trace that the loop reads without carrying
    # them (``x`` in ``acc = acc + x``, a tensor bound): the operator
    # takes them as its additional inputs, and inside its functions each
    # read of one is redirected to the operator's copy
    finder = _FreeTensors(flat)
    with finder:
        set_args(scatter(flat))
        cond_fn()
        body_fn()
    set_args(scatter(flat))
    free = list(finder.free.values())
    n_live = len(flat)

    def c(*vals):
        with _Redirect(free, vals[n_live:]):
            set_args(scatter(vals[:n_live]))
            return _scalar_pred(cond_fn())

    def b(*vals):
        with _Redirect(free, vals[n_live:]):
            set_args(scatter(vals[:n_live]))
            body_fn()
            return tuple(carried_out())

    out = while_loop_op(c, b, tuple(flat), tuple(free))
    set_args(scatter(list(out)))


class _FreeTensors(TorchFunctionMode):
    """Records the symbolic tensors that calls take but that are neither
    ``carried`` nor made inside (a loop's closure reads)."""

    def __init__(self, carried):
        super().__init__()
        self._made = {id(t) for t in carried}
        self.free = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in pytree.tree_leaves((args, kwargs)):
            if isinstance(a, torch.Tensor) and id(a) not in self._made \
                    and _is_symbolic(a):
                self.free.setdefault(id(a), a)
        out = func(*args, **kwargs)
        for o in pytree.tree_leaves(out):
            if isinstance(o, torch.Tensor):
                self._made.add(id(o))
        return out


class _Redirect(TorchFunctionMode):
    """Calls inside take ``inner[i]`` where they would take ``outer[i]``."""

    def __init__(self, outer, inner):
        super().__init__()
        self._map = {id(o): i for o, i in zip(outer, inner)}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        swap = (lambda a: self._map.get(id(a), a)
                if isinstance(a, torch.Tensor) else a)
        return func(*pytree.tree_map(swap, args),
                    **pytree.tree_map(swap, kwargs or {}))


def convert_while_loop(cond_fn: Callable, body_fn: Callable,
                       get_args: Callable, set_args: Callable):
    """Runtime for a rewritten ``while`` (reference
    ``convert_operators.py::convert_while_loop``)."""
    first = cond_fn()
    if not is_traced(first):
        saved = get_args()
        ok = _to_bool(first)
        traced_mid = False
        while ok:
            body_fn()
            nxt = cond_fn()
            if is_traced(nxt):
                # a break/return predicate inside went traced: the flag
                # machinery lifted the continuation test mid-loop.
                # Discard the partial unroll (its ops become dead code)
                # and functionalize from the loop entry instead — the
                # same restart convert_for does for traced breaks.
                traced_mid = True
                first = nxt
                break
            ok = _to_bool(nxt)
        if not traced_mid:
            return
        set_args(saved)
    if capturing(first):
        _host_read("a `while` loop on a tensor predicate")
    if first.is_meta:
        raise RuntimeError(
            "dy2static: a `while` loop on a static Variable predicate "
            "cannot be recorded into a Program; use paddle.jit.to_static")
    _while_export(cond_fn, body_fn, get_args, set_args, first)


class RangeSpec:
    """Deferred ``range(...)`` from a rewritten ``for`` — never calls the
    builtin, so a traced (tensor) bound is legal."""

    def __init__(self, *args):
        vals = list(args)
        if len(vals) == 1:
            self.start, self.stop, self.step = 0, vals[0], 1
        elif len(vals) == 2:
            self.start, self.stop, self.step = vals[0], vals[1], 1
        else:
            self.start, self.stop, self.step = vals

    def any_traced(self):
        return any(is_traced(v) for v in (self.start, self.stop, self.step))


class EnumSpec:
    """Deferred ``enumerate(seq[, start])``."""

    def __init__(self, seq, start=0):
        self.seq = seq
        self.start = start


def loop_cond(i, stop, step):
    """range-style continuation test, sign-aware for traced operands."""
    if not any(is_traced(v) for v in (i, stop, step)):
        return (i < stop) if step > 0 else (i > stop)
    if isinstance(step, torch.Tensor):
        return torch.where(step > 0, torch.as_tensor(i < stop),
                           torch.as_tensor(i > stop))
    return (i < stop) if step > 0 else (i > stop)


def _logical(fn, a, b):
    like = a if isinstance(a, torch.Tensor) else b
    ta = a if isinstance(a, torch.Tensor) else _full_like(bool(a), like)
    tb = b if isinstance(b, torch.Tensor) else _full_like(bool(b), like)
    return fn(ta, tb)


def loop_and(a, b):
    """``and`` of loop predicates that may be traced tensors."""
    if is_traced(a) or is_traced(b):
        return _logical(torch.logical_and, a, b)
    return bool(a) and bool(b)


def loop_guard(test_fn, brk):
    """``test and not brk`` for the rewritten ``while``, with Python's
    break semantics: once the break flag is concretely set the original
    test is NOT re-evaluated (real ``break`` exits without re-testing —
    the test may have side effects or raise on post-break state). A
    traced flag still evaluates both sides (while_loop semantics)."""
    nb = not_done(brk)
    if not is_traced(nb) and not bool(nb):
        return False
    return loop_and(test_fn(), nb)


def convert_for(spec, body_fn: Callable, get_args: Callable,
                set_args: Callable, stop: Callable | None = None):
    """Runtime for a rewritten ``for`` (reference
    ``loop_transformer.py::LoopTransformer`` — for→while conversion with
    loop-carried variable analysis; here the carried-state machinery is
    ``convert_while_loop``'s).

    ``spec``: a ``RangeSpec``/``EnumSpec`` (deferred builtins), a Tensor
    (iterate its leading dim), or any Python iterable (plain iteration —
    the honest fallback). ``body_fn(x)`` runs one iteration with the loop
    target(s) bound to ``x``; ``stop()`` reads the break flag planted by
    the break/continue pass (None when the body has no ``break``).

    A traced range bound goes through ``convert_while_loop``; everything
    concrete keeps exact Python semantics (and unrolls under a capture).
    """
    if isinstance(spec, EnumSpec):
        seq = spec.seq
        enum_from = spec.start
    else:
        seq = spec
        enum_from = None

    def run_indexed(n, index):
        for i in range(n):
            x = index(i)
            body_fn((enum_from + i, x) if enum_from is not None else x)
            if stop is not None and _to_bool_or_raise(stop()):
                break

    if isinstance(spec, RangeSpec):
        if not spec.any_traced():
            saved = get_args()
            try:
                i = spec.start
                while loop_cond(i, spec.stop, spec.step):
                    body_fn(i)
                    if stop is not None:
                        s = stop()
                        if is_traced(s):
                            # the break condition went traced mid-unroll:
                            # discard the partial unroll (its ops become
                            # dead code) and functionalize instead
                            raise _TracedFlow(s)
                        if bool(s):
                            break
                    i = i + spec.step
                return
            except _TracedFlow as flow:
                set_args(saved)
                like = flow.args[0]
        # traced bound (or traced break): counter joins the enclosing
        # loop-carried state and the whole thing functionalizes through
        # convert_while_loop
        else:
            like = next(v for v in (spec.start, spec.stop, spec.step)
                        if isinstance(v, torch.Tensor))
        start = spec.start
        box = [start if isinstance(start, torch.Tensor)
               else torch.full((), start, device=like.device)]

        def cond_fn():
            c = loop_cond(box[0], spec.stop, spec.step)
            if stop is not None:
                c = loop_and(c, not_done(stop()))
            return c

        def body():
            i = box[0]
            body_fn(i)
            box[0] = i + spec.step

        def get2():
            return get_args() + [box[0]]

        def set2(vals):
            set_args(vals[:-1])
            box[0] = vals[-1]

        convert_while_loop(cond_fn, body, get2, set2)
        return

    if isinstance(seq, torch.Tensor):
        run_indexed(int(seq.shape[0]), lambda i: seq[i])
        return
    if isinstance(seq, (list, tuple)):
        run_indexed(len(seq), lambda i: seq[i])
        return
    # arbitrary Python iterable (dict, generator, zip, ...): plain
    # iteration, identical to the untransformed function
    k = 0
    for x in seq:
        body_fn((enum_from + k, x) if enum_from is not None else x)
        k += 1
        if stop is not None and _to_bool_or_raise(stop()):
            break


class _TracedFlow(Exception):
    """Internal: a flow flag became traced inside a concrete-bound
    range loop — restart down the functionalized path."""


def _to_bool_or_raise(x):
    if is_traced(x):
        raise ValueError(
            "dy2static: `break` depends on a traced tensor inside a loop "
            "that cannot functionalize (iteration over a Python sequence "
            "or tensor rows); use a `range()` loop over indices, or keep "
            "the break condition concrete")
    return bool(x)


# ------------------------------------------------------------ transformer --


def _store_names(nodes) -> Set[str]:
    out: Set[str] = set()

    class V(ast.NodeVisitor):
        def visit_Name(self, node):
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                out.add(node.id)

        def visit_FunctionDef(self, node):
            out.add(node.name)  # don't descend into nested defs

        def visit_AsyncFunctionDef(self, node):
            out.add(node.name)

        def visit_ClassDef(self, node):
            out.add(node.name)

        def _import(self, node):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                out.add(name)

        visit_Import = _import
        visit_ImportFrom = _import

        def visit_Lambda(self, node):
            pass

    for n in nodes:
        V().visit(n)
    return out


def _load_names(nodes) -> Set[str]:
    out: Set[str] = set()

    class V(ast.NodeVisitor):
        def visit_Name(self, node):
            if isinstance(node.ctx, ast.Load):
                out.add(node.id)

    for n in nodes:
        V().visit(n)
    return out


def _has_flow_escape(nodes) -> bool:
    """return/break/continue inside would escape the converted block."""

    class V(ast.NodeVisitor):
        found = False

        def visit_Return(self, node):
            self.found = True

        def visit_Break(self, node):
            self.found = True

        def visit_Continue(self, node):
            self.found = True

        def visit_FunctionDef(self, node):
            pass  # nested functions keep their own control flow

        def visit_While(self, node):
            # break/continue bound to the inner loop are fine; only scan
            # its BODY for returns. The orelse binds OUTWARD (a break
            # there leaves the enclosing loop), so scan it normally.
            for n in node.body:
                for sub in ast.walk(n):
                    if isinstance(sub, ast.Return):
                        self.found = True
            for n in node.orelse:
                self.visit(n)

        visit_For = visit_While

    v = V()
    for n in nodes:
        v.visit(n)
    return v.found


def _contains(nodes, kinds) -> bool:
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, kinds):
                return True
    return False


def _loop_flow_escapes(nodes) -> bool:
    """True when converting a loop whose body is ``nodes`` could change
    semantics, so the transformer must keep the raw Python loop:

    - ``return``/``yield`` at the loop's OWN scope (they escape the
      body function the rewrite would create);
    - ``nonlocal``/``global`` anywhere — including inside nested USER
      functions, whose closure mutations reach outward and would be
      invisible to the loop-carried-state analysis. Generated
      ``__jst_*`` helper defs are exempt: their ``nonlocal``/``return``
      ARE the conversion machinery of an already-transformed inner
      loop (this is what makes nested conversions compose)."""

    def walk(n, nested):
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if child.name.startswith("__jst_"):
                    continue
                if walk(child, True):
                    return True
                continue
            if isinstance(child, ast.ClassDef):
                if walk(child, True):
                    return True
                continue
            if isinstance(child, (ast.Global, ast.Nonlocal)):
                return True
            if not nested and isinstance(
                    child, (ast.Return, ast.Yield, ast.YieldFrom)):
                return True
            if walk(child, nested):
                return True
        return False

    for n in nodes:
        if isinstance(n, (ast.Global, ast.Nonlocal)):
            return True
        if isinstance(n, (ast.Return,)):
            return True
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not n.name.startswith("__jst_") and walk(n, True):
                return True
            continue
        if walk(n, False):
            return True
    return False


# weak keys: per-call-defined helpers (new function object each call)
# must not pin their closures — incl. captured arrays — forever
_CONVERTED_CACHE = weakref.WeakKeyDictionary()


def _is_library_module(module: str) -> bool:
    """True for stdlib and installed (site/dist-packages) modules —
    code the user didn't write, which ``convert_call`` must never
    AST-recompile."""
    import sys

    if not module:
        return False
    top = module.split(".", 1)[0]
    if (top in getattr(sys, "stdlib_module_names", ())
            or top in sys.builtin_module_names):
        return True
    mod = sys.modules.get(top)
    path = getattr(mod, "__file__", None) or ""
    return "site-packages" in path or "dist-packages" in path


def convert_call(fn):
    """Runtime for a rewritten call site (reference
    ``convert_call_func.py::convert_call`` via ``call_transformer.py``):
    plain user functions get recursively AST-converted (cached) so
    traced control flow inside helpers works; builtins, framework/torch/
    numpy callables, classes, and Layers pass through untouched."""
    import types

    if not isinstance(fn, (types.FunctionType, types.MethodType)):
        return fn  # builtins, classes, Layers (__call__ traces), partials
    target = fn.__func__ if isinstance(fn, types.MethodType) else fn
    if getattr(target, "__jst_converted__", False):
        return fn
    if (inspect.isgeneratorfunction(target)
            or inspect.iscoroutinefunction(target)
            or inspect.isasyncgenfunction(target)):
        # extracting loop bodies would destroy generator-ness
        return fn
    if getattr(target, "__wrapped__", None) is not None:
        # a functools.wraps-style decorated helper: getsource would
        # follow __wrapped__ and compile the UNDECORATED def, silently
        # bypassing the wrapper — keep the decorated callable as-is
        return fn
    module = getattr(target, "__module__", "") or ""
    if any(module == pkg or module.startswith(pkg + ".")
           for pkg in ("paddle_tpu_torch", "paddle_tpu", "torch", "numpy",
                       "jax")):
        return fn
    if _is_library_module(module):
        # stdlib / installed third-party helpers (logging, copy, ...)
        # are never user model code: recompiling them rewrites call
        # sites they rely on for introspection (logging.findCaller walks
        # the stack by code object; tracebacks point at synthetic
        # sources) for zero tracing benefit
        return fn
    if target.__name__ == "<lambda>" or not ast_transformable(target):
        return fn
    cached = _CONVERTED_CACHE.get(target)
    if cached is None:
        try:
            cached = convert_to_static_ast(target)
            if cached is not target:
                cached.__jst_converted__ = True
        except Exception:
            cached = target  # unconvertible: call as-is (honest fallback)
        _CONVERTED_CACHE[target] = cached
    if cached is target:
        return fn
    if isinstance(fn, types.MethodType):
        return types.MethodType(cached, fn.__self__)
    return cached


def convert_logical_and(*fns):
    """Runtime for a rewritten ``a and b`` (reference
    ``convert_operators.py::convert_logical_and`` via
    ``logical_transformer.py``): exact Python value semantics — incl.
    short-circuit — while every operand is concrete; once a traced
    operand appears, the remaining operands are evaluated eagerly and
    folded with ``torch.logical_and`` (the reference's eager-both-sides
    semantics for tensor operands)."""
    acc = None
    last = None
    for f in fns:
        v = f()
        if acc is None and not is_traced(v):
            if not _to_bool(v):
                return v  # short-circuit: return the falsy value itself
            last = v
            continue
        acc = v if acc is None else _logical(torch.logical_and, acc, v)
    return last if acc is None else _logical(torch.logical_and, acc, True)


def convert_logical_or(*fns):
    """Runtime for a rewritten ``a or b`` — mirror of
    :func:`convert_logical_and`."""
    acc = None
    last = None
    for f in fns:
        v = f()
        if acc is None and not is_traced(v):
            if _to_bool(v):
                return v  # short-circuit: return the truthy value itself
            last = v
            continue
        acc = v if acc is None else _logical(torch.logical_or, acc, v)
    return last if acc is None else _logical(torch.logical_or, acc, False)


def convert_logical_not(v):
    """Runtime for a rewritten ``not x`` (reference
    ``convert_operators.py::convert_logical_not``)."""
    if is_traced(v):
        return torch.logical_not(v)
    return not _to_bool(v)


def convert_cast(py_type, v):
    """Runtime for a rewritten ``int(x)``/``float(x)``/``bool(x)``
    (reference ``cast_transformer.py``): a traced operand becomes a
    dtype cast (``int`` truncates toward zero like Python); concrete
    operands keep exact Python semantics. ``py_type`` is the call's
    ORIGINAL callable, so a user-shadowed name behaves as written."""
    if is_traced(v) and py_type in (int, float, bool):
        if v.numel() != 1:
            # eager int(x)/float(x)/bool(x) raises on multi-element
            # tensors; a silent elementwise cast would change output
            # shapes vs eager (mirrors convert_ifelse's scalar check)
            raise ValueError(
                "dy2static: cast of a traced tensor with "
                f"{v.numel()} elements; only scalar tensors support "
                f"{py_type.__name__}(x)")
        if py_type is bool:
            return v.to(torch.bool)
        if py_type is int:
            # keep the input's integer width: int(x) on an int64 tensor
            # must not narrow, and float64 inputs carry values past 2**31
            if not v.is_floating_point() and v.dtype != torch.bool:
                return v
            if v.dtype == torch.float64:
                return torch.trunc(v).to(torch.int64)
            return torch.trunc(v.float() if v.dtype == torch.bool else v
                               ).to(torch.int32)
        return v.to(torch.float32)
    return py_type(v)


def convert_print(*args, **kwargs):
    """Runtime for a rewritten ``print`` (reference
    ``print_transformer.py``). A tensor under CUDA-graph capture cannot
    be printed from a replay (a host read: :class:`CaptureUnsupported`);
    a symbolic one (export, the static recorder) prints as it is at
    trace time; everything else prints as ``print`` does."""
    if any(capturing(a) for a in args):
        _host_read("`print` of a tensor")
    print(*args, **kwargs)


def convert_assert(test_fn, msg_fn=None):
    """Runtime for a rewritten ``assert`` (reference
    ``assert_transformer.py``): concrete tests keep exact Python raise
    semantics. A test on a tensor under capture would read the device
    on the host (:class:`CaptureUnsupported`); a symbolic test (export,
    the static recorder) is not checked: no host reads the data."""
    v = test_fn()
    if not is_traced(v):
        if not _to_bool(v):
            raise AssertionError(msg_fn() if msg_fn else None)
        return
    if capturing(v):
        _host_read("`assert` on a tensor")


def not_done(done):
    """Guard predicate for post-return/break/continue statements."""
    if isinstance(done, torch.Tensor):
        return torch.logical_not(done)
    return not done


def false_():
    # a plain Python bool: a tensor here would force every flow flag
    # down the traced path even for fully concrete control flow
    return False


def true_():
    return True


def _lambda0(body_expr):
    """A zero-arg lambda deferring ``body_expr`` (for short-circuit)."""
    return ast.Lambda(
        args=ast.arguments(posonlyargs=[], args=[], vararg=None,
                           kwonlyargs=[], kw_defaults=[], kwarg=None,
                           defaults=[]),
        body=body_expr)


def _jst_call(name, args):
    return ast.Call(
        func=ast.Attribute(value=ast.Name(id="__jst", ctx=ast.Load()),
                           attr=name, ctx=ast.Load()),
        args=args, keywords=[])


class _LogicalTransformer(ast.NodeTransformer):
    """Rewrites ``and``/``or``/``not`` (reference
    ``logical_transformer.py``): bare ``a and b`` on traced tensors
    would ``bool()`` a tracer and raise; the converter calls preserve
    Python short-circuit value semantics concretely and lift to
    ``torch.logical_*`` when traced. Operands ride zero-arg lambdas so
    short-circuit still skips their evaluation."""

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        if any(isinstance(n, ast.NamedExpr)
               for v in node.values for n in ast.walk(v)):
            # a walrus must bind in the ENCLOSING scope; the deferring
            # lambda would capture it (PEP 572) — keep the bare op
            return node
        name = ("convert_logical_and" if isinstance(node.op, ast.And)
                else "convert_logical_or")
        call = _jst_call(name, [_lambda0(v) for v in node.values])
        return ast.copy_location(call, node)

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            call = _jst_call("convert_logical_not", [node.operand])
            return ast.copy_location(call, node)
        return node


class _CastTransformer(ast.NodeTransformer):
    """Rewrites single-arg ``int()``/``float()``/``bool()`` calls
    (reference ``cast_transformer.py``) so traced operands cast instead
    of raising a tracer-coercion error."""

    def visit_Call(self, node):
        self.generic_visit(node)
        if (isinstance(node.func, ast.Name)
                and node.func.id in ("int", "float", "bool")
                and len(node.args) == 1 and not node.keywords
                and not isinstance(node.args[0], ast.Starred)):
            call = _jst_call("convert_cast", [node.func, node.args[0]])
            return ast.copy_location(call, node)
        return node


class _CallTransformer(ast.NodeTransformer):
    """Wraps call sites in ``__jst.convert_call`` (reference
    ``call_transformer.py``) so user helper functions are recursively
    converted at first call. Builtins that other transformers or the
    zero-arg-``super`` frame magic depend on are left bare; everything
    else is decided at runtime by :func:`convert_call`."""

    _SKIP_NAMES = {"print", "super", "isinstance", "issubclass", "len",
                   "range", "enumerate", "zip", "map", "filter", "type",
                   "getattr", "setattr", "hasattr", "locals", "globals"}

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        if isinstance(f, ast.Name) and f.id in self._SKIP_NAMES:
            return node
        if isinstance(f, ast.Attribute) and isinstance(
                f.value, ast.Name) and f.value.id == "__jst":
            return node
        node.func = ast.copy_location(
            _jst_call("convert_call", [f]), f)
        return node


class _PrintTransformer(ast.NodeTransformer):
    """Rewrites ``print(...)`` calls (reference
    ``print_transformer.py``) to route traced operands through
    a traced-aware ``convert_print``."""

    def visit_Call(self, node):
        self.generic_visit(node)
        if (isinstance(node.func, ast.Name) and node.func.id == "print"
                and not any(isinstance(a, ast.Starred)
                            for a in node.args)):
            node.func = ast.copy_location(
                ast.Attribute(value=ast.Name(id="__jst", ctx=ast.Load()),
                              attr="convert_print", ctx=ast.Load()),
                node.func)
        return node


class _AssertTransformer(ast.NodeTransformer):
    """Rewrites ``assert`` statements (reference
    ``assert_transformer.py``): the test and message defer behind
    lambdas so a passing concrete assert stays lazy, and a traced test
    checks at run time instead of bool()-ing a tracer."""

    def visit_Assert(self, node):
        self.generic_visit(node)
        walrus_src = [node.test] + ([node.msg] if node.msg else [])
        if any(isinstance(n, ast.NamedExpr)
               for v in walrus_src for n in ast.walk(v)):
            return node  # lambda would capture the walrus binding
        args = [_lambda0(node.test)]
        if node.msg is not None:
            args.append(_lambda0(node.msg))
        call = ast.Expr(value=_jst_call("convert_assert", args))
        return ast.copy_location(call, node)


def _own_returns(nodes):
    """Return nodes bound to THIS function: nested function/class defs
    keep their own returns and are not descended into."""
    out = []
    stack = list(nodes)
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Return):
            out.append(n)
            continue
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return out


class _ReturnTransformer:
    """Rewrites early returns (reference ``return_transformer.py``):
    ``return X`` becomes ``__jst_ret = X; __jst_done = true`` and
    statements after a returning If are wrapped in
    ``if not_done(__jst_done):`` — which the control-flow pass then
    converts, so a traced predicate cascades correctly.

    Returns INSIDE loops additionally emit a ``break``; enclosing loops
    get an ``if __jst_done: break`` cascade after each inner loop that
    can return, and the downstream break/continue pass converts those
    exactly like user-written breaks (traced predicates included).
    Like Python's own ``return``, the synthetic break skips any
    ``for``/``while`` else clause."""

    RET = "__jst_ret"
    DONE = "__jst_done"

    def apply(self, fdef: ast.FunctionDef) -> bool:
        body = fdef.body
        early = [r for r in _own_returns(body)
                 if r is not body[-1]]
        if not early:
            return False
        if not isinstance(body[-1], ast.Return):
            return False  # implicit-None tail path: keep Python semantics
        # a return inside a loop's ELSE clause runs at enclosing scope
        # after a flagged loop exit — a shape v2 doesn't express
        for n in ast.walk(fdef):
            if isinstance(n, (ast.For, ast.While)) and _own_returns(
                    n.orelse):
                return False
        prologue = ast.parse(
            f"{self.DONE} = __jst.false_()\n{self.RET} = __jst.UNDEFINED"
        ).body
        new_body = prologue + self._transform(body)
        new_body.append(ast.parse(f"return {self.RET}").body[0])
        fdef.body = [ast.fix_missing_locations(
            ast.copy_location(n, fdef.body[0])) for n in new_body]
        return True

    def _transform(self, stmts):
        out = []
        for idx, st in enumerate(stmts):
            if isinstance(st, ast.Return):
                val = st.value or ast.Constant(value=None)
                out.append(ast.Assign(
                    targets=[ast.Name(id=self.RET, ctx=ast.Store())],
                    value=val))
                out.append(ast.parse(
                    f"{self.DONE} = __jst.true_()").body[0])
                return out  # statements after a bare return are dead
            if isinstance(st, ast.If) and _own_returns([st]):
                st = ast.If(test=st.test,
                            body=self._transform(st.body),
                            orelse=self._transform(st.orelse)
                            if st.orelse else [])
                out.append(st)
                rest = stmts[idx + 1:]
                if rest:
                    guard = ast.If(
                        test=ast.parse(
                            f"__jst.not_done({self.DONE})",
                            mode="eval").body,
                        body=self._transform(rest), orelse=[])
                    out.append(guard)
                return out
            if isinstance(st, (ast.For, ast.While)) and _own_returns(
                    [st]):
                st.body = self._loop_body(st.body)
                out.append(st)
                rest = stmts[idx + 1:]
                if rest:
                    guard = ast.If(
                        test=ast.parse(
                            f"__jst.not_done({self.DONE})",
                            mode="eval").body,
                        body=self._transform(rest), orelse=[])
                    out.append(guard)
                return out
            out.append(st)
        return out

    def _loop_body(self, stmts):
        """Inside a loop: return -> set flags + break. Python's own
        break semantics then skip the rest of the iteration, and the
        enclosing-loop cascade propagates the exit outward."""
        out = []
        for st in stmts:
            if isinstance(st, ast.Return):
                val = st.value or ast.Constant(value=None)
                out.append(ast.Assign(
                    targets=[ast.Name(id=self.RET, ctx=ast.Store())],
                    value=val))
                out.append(ast.parse(
                    f"{self.DONE} = __jst.true_()").body[0])
                out.append(ast.Break())
                return out  # dead code after a bare return
            if isinstance(st, ast.If) and _own_returns([st]):
                st = ast.If(test=st.test,
                            body=self._loop_body(st.body),
                            orelse=self._loop_body(st.orelse)
                            if st.orelse else [])
                out.append(st)
                continue
            if isinstance(st, (ast.For, ast.While)) and _own_returns(
                    [st]):
                st.body = self._loop_body(st.body)
                out.append(st)
                out.append(ast.parse(
                    f"if {self.DONE}:\n    break").body[0])
                continue
            out.append(st)
        return out


class _BreakContinueTransformer(ast.NodeTransformer):
    """Removes ``break``/``continue`` from loop bodies (reference
    ``break_continue_transformer.py``): each becomes a flag assignment,
    statements after a flag-setting If are guarded by
    ``if __jst.not_done(flag)``, and the loop's continuation test gains
    ``and not break_flag``. The guards are plain ``if`` nodes, so a
    traced break condition cascades through ``convert_ifelse`` exactly
    like a traced early return."""

    _n = 0

    @classmethod
    def _fresh(cls, base):
        cls._n += 1
        return f"__jst_{base}_{cls._n}"

    @staticmethod
    def _directly_contains(body, kinds):
        """break/continue bound to THIS loop that the guard rewrite can
        reach: top-level statements and If branches only."""
        found = []

        def walk(stmts):
            for st in stmts:
                if isinstance(st, kinds):
                    found.append(st)
                elif isinstance(st, ast.If):
                    walk(st.body)
                    walk(st.orelse)
                # While/For/FunctionDef: their break/continue bind inner
        walk(body)
        return found

    @staticmethod
    def _bound_flow(body):
        """ALL break/continue bound to this loop, including ones hiding
        under with/try blocks the guard rewrite cannot reach."""
        found = []

        def walk(stmts):
            for st in stmts:
                if isinstance(st, (ast.Break, ast.Continue)):
                    found.append(st)
                elif isinstance(st, ast.If):
                    walk(st.body)
                    walk(st.orelse)
                elif isinstance(st, ast.With):
                    walk(st.body)
                elif isinstance(st, ast.Try):
                    walk(st.body)
                    for h in st.handlers:
                        walk(h.body)
                    walk(st.orelse)
                    walk(st.finalbody)
                elif isinstance(st, (ast.For, ast.While)):
                    # the nested loop's BODY binds its own break/continue,
                    # but its orelse binds to THIS loop
                    walk(st.orelse)
        walk(body)
        return found

    def _guard_rest(self, stmts, flags):
        """Bottom-up: after any statement that can set a flow flag, wrap
        the remaining statements in ``if not_done(flag-or)``."""
        out = []
        for idx, st in enumerate(stmts):
            if isinstance(st, (ast.Break, ast.Continue)):
                flag = flags["brk" if isinstance(st, ast.Break) else "cont"]
                out.append(ast.parse(f"{flag} = __jst.true_()").body[0])
                return out  # dead code after a bare break/continue
            if isinstance(st, ast.If) and self._directly_contains(
                    [st], (ast.Break, ast.Continue)):
                st = ast.If(test=st.test,
                            body=self._guard_rest(st.body, flags),
                            orelse=(self._guard_rest(st.orelse, flags)
                                    if st.orelse else []))
                out.append(st)
                rest = stmts[idx + 1:]
                if rest:
                    used = [f for f in (flags.get("brk"), flags.get("cont"))
                            if f]
                    if len(used) == 1:
                        test = f"__jst.not_done({used[0]})"
                    else:  # loop_and: a bare `and` would bool() a tracer
                        test = (f"__jst.loop_and(__jst.not_done({used[0]}), "
                                f"__jst.not_done({used[1]}))")
                    guard = ast.If(
                        test=ast.parse(test, mode="eval").body,
                        body=self._guard_rest(rest, flags), orelse=[])
                    out.append(guard)
                return out
            out.append(st)
        return out

    def _transform_loop(self, node):
        self.generic_visit(node)
        bound = self._bound_flow(node.body)
        if not bound:
            return node
        breaks = self._directly_contains(node.body, ast.Break)
        conts = self._directly_contains(node.body, ast.Continue)
        if len(bound) != len(breaks) + len(conts):
            # flow hiding under with/try: keep the raw Python loop —
            # correct for concrete predicates, loud for traced
            # ones (the round-3 status quo)
            return node
        orelse = node.orelse
        if isinstance(node, ast.For) and (
                not _simple_target(node.target)
                or _loop_flow_escapes(node.body)):
            # _ForTransformer will bail on this loop; rewriting the body
            # here would strand flag-breaks nothing enforces
            return node
        flags = {}
        pre = []
        if breaks:
            flags["brk"] = self._fresh("brk")
            pre.append(ast.parse(
                f"{flags['brk']} = __jst.false_()").body[0])
        if conts:
            flags["cont"] = self._fresh("cont")
        body = self._guard_rest(node.body, flags)
        if conts:
            # reset at the top of every iteration
            body = [ast.parse(
                f"{flags['cont']} = __jst.false_()").body[0]] + body
        node.body = body
        if breaks:
            node._jst_break_flag = flags["brk"]
            if isinstance(node, ast.While):
                if any(isinstance(n, ast.NamedExpr)
                       for n in ast.walk(node.test)):
                    # a walrus in the test must bind in the enclosing
                    # scope — a lambda would capture it. Inline splice:
                    # loses only the no-retest-after-break nicety.
                    wrapped = ast.parse(
                        f"__jst.loop_and(None, "
                        f"__jst.not_done({flags['brk']}))",
                        mode="eval").body
                    wrapped.args[0] = node.test
                else:
                    # lambda defers the original test so loop_guard can
                    # skip re-evaluating it once break concretely fired
                    wrapped = ast.parse(
                        f"__jst.loop_guard(lambda: None, {flags['brk']})",
                        mode="eval").body
                    wrapped.args[0].body = node.test
                node.test = wrapped
        post = []
        if orelse:
            # for/while-else (reference break_continue_transformer +
            # loop else semantics): the else body runs iff the loop was
            # not left by break. With the break flag that is exactly
            # `if not_done(brk): <else>` after the loop; without breaks
            # the else always runs, so it simply follows the loop.
            node.orelse = []
            if breaks:
                guard = ast.If(
                    test=ast.parse(
                        f"__jst.not_done({flags['brk']})",
                        mode="eval").body,
                    body=orelse, orelse=[])
                post.append(guard)
            else:
                post.extend(orelse)
        for n in pre + [node] + post:
            ast.copy_location(n, node)
            ast.fix_missing_locations(n)
        return pre + [node] + post

    visit_While = _transform_loop
    visit_For = _transform_loop


def _simple_target(t) -> bool:
    if isinstance(t, ast.Name):
        return True
    if isinstance(t, ast.Tuple):
        return all(_simple_target(e) for e in t.elts)
    return False


def _gen_state_helpers(fresh, names):
    """get/set closure defs over enclosing locals via nonlocal blocks
    (shared by the For and If/While transformers)."""
    get_name = fresh("get")
    set_name = fresh("set")
    get_def = ast.parse(textwrap.dedent(f"""
        def {get_name}():
            return [{', '.join(names) if names else ''}]
    """)).body[0]
    set_body = "\n".join(
        f"    {n} = __jst_vals[{i}]" for i, n in enumerate(names)
    ) or "    pass"
    nl = f"    nonlocal {', '.join(names)}\n" if names else ""
    set_def = ast.parse(
        f"def {set_name}(__jst_vals):\n{nl}{set_body}\n").body[0]
    return get_name, set_name, [get_def, set_def]


class _ForTransformer(ast.NodeTransformer):
    """Rewrites ``for`` into a ``convert_for`` call (reference
    ``loop_transformer.py:507`` — for→while conversion with loop-carried
    variable analysis; the carried-state machinery here is
    ``convert_while_loop``'s). ``range``/``enumerate`` iterators are
    deferred as specs so a traced bound never hits the builtin — it
    goes through ``convert_while_loop`` at runtime; everything concrete keeps
    exact Python semantics (incl. plain iteration over dicts/generators).
    Runs AFTER the break/continue pass (bodies are flag-based by now,
    ``_jst_break_flag`` marks loops that can stop early) and BEFORE the
    If/While pass (the emitted flag guards still need conversion)."""

    _n = 0

    @classmethod
    def _fresh(cls, base):
        cls._n += 1
        return f"__jst_f{base}_{cls._n}"

    def _state_helpers(self, names):
        return _gen_state_helpers(self._fresh, names)

    def visit_For(self, node):
        self.generic_visit(node)
        if node.orelse or not _simple_target(node.target):
            return node
        if _loop_flow_escapes(node.body):
            return node
        if _BreakContinueTransformer._bound_flow(node.body):
            # raw break/continue the flag pass chose not to rewrite
            # (with/try, for-else): a body-function extraction would be a
            # SyntaxError — keep the Python loop
            return node
        spec_name = self._fresh("spec")
        body_name = self._fresh("body")
        x_name = self._fresh("x")

        it = node.iter
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id in ("range", "enumerate")
                and not any(isinstance(a, ast.Starred) for a in it.args)):
            cls = "RangeSpec" if it.func.id == "range" else "EnumSpec"
            spec_val = ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id="__jst", ctx=ast.Load()),
                    attr=cls, ctx=ast.Load()),
                args=it.args, keywords=it.keywords)
        else:
            spec_val = it

        tgt_assign = ast.Assign(targets=[node.target],
                                value=ast.Name(id=x_name, ctx=ast.Load()))
        state = sorted(_store_names([tgt_assign] + node.body))
        init = [ast.parse(
            f"{n} = __jst_probe(lambda: {n})").body[0] for n in state]
        get_name, set_name, helpers = self._state_helpers(state)
        nl = ([ast.Nonlocal(names=list(state))] if state else [])
        body_fn = ast.FunctionDef(
            name=body_name,
            args=ast.arguments(
                posonlyargs=[],
                args=[ast.arg(arg=x_name, annotation=None)], vararg=None,
                kwonlyargs=[], kw_defaults=[], kwarg=None, defaults=[]),
            body=nl + [tgt_assign] + node.body,
            decorator_list=[])
        brk = getattr(node, "_jst_break_flag", None)
        stop_src = f"lambda: {brk}" if brk else "None"
        call = ast.parse(
            f"__jst.convert_for({spec_name}, {body_name}, {get_name}, "
            f"{set_name}, stop={stop_src})").body[0]
        spec_assign = ast.Assign(
            targets=[ast.Name(id=spec_name, ctx=ast.Store())],
            value=spec_val)
        out = init + [spec_assign, body_fn, *helpers, call]
        for n in out:
            ast.copy_location(n, node)
            ast.fix_missing_locations(n)
        return out


class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrites If/While whose condition may be tensor-dependent."""

    def __init__(self):
        self._counter = 0
        self.failed_reason = None

    def _fresh(self, base):
        self._counter += 1
        return f"__jst_{base}_{self._counter}"

    def _state_helpers(self, names: List[str]):
        """get/set closures over enclosing locals via nonlocal blocks."""
        return _gen_state_helpers(self._fresh, names)

    def _branch_fn(self, name, body, names):
        nl = ([ast.Nonlocal(names=list(names))] if names else [])
        fn = ast.FunctionDef(
            name=name,
            args=ast.arguments(posonlyargs=[], args=[], vararg=None,
                               kwonlyargs=[], kw_defaults=[], kwarg=None,
                               defaults=[]),
            body=nl + (body or [ast.Pass()]),
            decorator_list=[],
        )
        return fn

    def visit_If(self, node):
        self.generic_visit(node)
        if _has_flow_escape(node.body) or _has_flow_escape(node.orelse):
            # return/break/continue inside — leave as a Python if (works
            # for concrete predicates; traced predicates raise)
            return node
        assigned = sorted(_store_names(node.body) | _store_names(node.orelse))
        t_name = self._fresh("true")
        f_name = self._fresh("false")
        get_name, set_name, helpers = self._state_helpers(assigned)
        # bind every branch-assigned name at this level (current value, or
        # UNDEFINED when unbound) so the branch fns' `nonlocal` is legal
        init = [ast.parse(
            f"{n} = __jst_probe(lambda: {n})").body[0] for n in assigned]
        cond_var = self._fresh("condval")  # fresh: never visible as state
        call = ast.parse(
            f"__jst.convert_ifelse({cond_var}, {t_name}, {f_name}, "
            f"{get_name}, {set_name})").body[0]
        cond_assign = ast.Assign(
            targets=[ast.Name(id=cond_var, ctx=ast.Store())],
            value=node.test)
        out = init + [
            cond_assign,
            self._branch_fn(t_name, node.body, assigned),
            self._branch_fn(f_name, node.orelse, assigned),
            *helpers,
            call,
        ]
        for n in out:
            ast.copy_location(n, node)
            ast.fix_missing_locations(n)
        return out

    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse or _has_flow_escape(node.body):
            return node
        # loop state = names assigned in the body (test-read loop
        # invariants ride the closure as constants); bind each at this
        # level first so the body fn's `nonlocal` is legal, with UNDEFINED
        # marking per-iteration temps
        state = sorted(_store_names(node.body))
        init = [ast.parse(
            f"{n} = __jst_probe(lambda: {n})").body[0] for n in state]
        cond_name = self._fresh("cond")
        body_name = self._fresh("body")
        get_name, set_name, helpers = self._state_helpers(state)
        cond_fn = ast.FunctionDef(
            name=cond_name,
            args=ast.arguments(posonlyargs=[], args=[], vararg=None,
                               kwonlyargs=[], kw_defaults=[], kwarg=None,
                               defaults=[]),
            body=[ast.Return(value=node.test)],
            decorator_list=[])
        body_fn = self._branch_fn(body_name, node.body, state)
        call = ast.parse(
            f"__jst.convert_while_loop({cond_name}, {body_name}, "
            f"{get_name}, {set_name})").body[0]
        out = init + [cond_fn, body_fn, *helpers, call]
        for n in out:
            ast.copy_location(n, node)
            ast.fix_missing_locations(n)
        return out


def _probe(thunk):
    try:
        return thunk()
    except (NameError, UnboundLocalError):
        return UNDEFINED


class _ExecGlobals(dict):
    """Globals for a transformed function: owns only the injected
    ``__jst`` helpers (+ whatever exec adds, e.g. ``__builtins__``),
    delegating every miss to the original function's live module
    globals — so module-level rebinds stay visible without the
    conversion machinery ever touching ``vars(module)``."""

    __slots__ = ("_base",)

    def __init__(self, base):
        super().__init__()
        self._base = base
        self["__jst"] = sys.modules[__name__]
        self["__jst_probe"] = _probe

    def __missing__(self, key):
        return self._base[key]


def ast_transformable(fn) -> bool:
    try:
        src = inspect.getsource(fn)
        textwrap.dedent(src)
        return True
    except (OSError, TypeError):
        return False


def convert_to_static_ast(fn: Callable) -> Callable:
    """Rewrite fn's AST (If/While) for tensor-predicate control flow.

    Returns the rewritten function, or raises if the source is not
    available (lambdas, REPL) — callers fall back to trace-only mode.
    """
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not _contains(fdef.body, (ast.If, ast.While, ast.For)):
        return fn  # nothing to convert — keep live-globals trace behavior
    # strip decorators (we're already past them)
    fdef.decorator_list = []
    if "print" not in _store_names(fdef.body):  # locally rebound: leave
        _PrintTransformer().visit(fdef)
    _CastTransformer().visit(fdef)
    _CallTransformer().visit(fdef)
    _LogicalTransformer().visit(fdef)
    _AssertTransformer().visit(fdef)
    _ReturnTransformer().apply(fdef)
    _BreakContinueTransformer().visit(fdef)
    _ForTransformer().visit(fdef)
    tr = _ControlFlowTransformer()
    tr.visit(fdef)
    ast.fix_missing_locations(tree)

    freevars = list(fn.__code__.co_freevars)
    if freevars:
        # rebind the original closure: wrap the transformed def in a
        # factory taking each freevar as a parameter, then call it with the
        # original cell contents (values snapshot at conversion time, same
        # caveat as the reference's transpiler)
        factory = ast.parse(
            f"def __jst_factory__({', '.join(freevars)}):\n"
            f"    return None").body[0]
        factory.body = [fdef, ast.parse(f"return {fdef.name}").body[0]]
        tree = ast.Module(body=[factory], type_ignores=[])
        ast.fix_missing_locations(tree)

    code = compile(tree, filename=f"<dy2static {fn.__name__}>", mode="exec")
    # the transformed function must see the function's LIVE globals (not
    # a snapshot) so later module-level mutations stay visible, exactly
    # like the untransformed function — but WITHOUT writing the __jst
    # helpers into the defining module's dict (a foreign module's
    # namespace is not ours to mutate; vars(module) must stay clean).
    # _ExecGlobals holds only the helpers and delegates every other
    # lookup to fn.__globals__ via __missing__, which CPython honors
    # for dict subclasses in LOAD_GLOBAL. Exceptions that must run
    # against the real module dict: `global` writes (STORE_GLOBAL
    # bypasses dict-subclass __setitem__, so the write would land in
    # the shadow namespace) and reflective access (`globals()`/`vars`/
    # `eval`/`exec` hand back the raw shadow dict, not the module).
    def _needs_real_globals(n):
        if isinstance(n, ast.Global):
            return True
        return (isinstance(n, ast.Name)
                and n.id in ("globals", "vars", "eval", "exec"))

    if any(_needs_real_globals(n) for n in ast.walk(tree)):
        glb = fn.__globals__
        glb["__jst"] = sys.modules[__name__]
        glb["__jst_probe"] = _probe
    else:
        glb = _ExecGlobals(fn.__globals__)
    ns: dict = {}
    exec(code, glb, ns)  # noqa: S102 — compiling the user's own source
    if freevars:
        cells = [c.cell_contents for c in fn.__closure__]
        new_fn = ns["__jst_factory__"](*cells)
    else:
        new_fn = ns[fdef.name]
    new_fn = functools.wraps(fn)(new_fn)
    return new_fn


_code_level = 0
_verbosity = 0


class ProgramTranslator:
    """Reference ``program_translator.py:1118`` singleton facade: global
    enable/disable switch for to_static (the trace-based compiler here)."""

    _instance = None
    enable_to_static = True

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    @classmethod
    def get_instance(cls):
        return cls()

    def enable(self, enable_to_static=True):
        type(self).enable_to_static = bool(enable_to_static)
