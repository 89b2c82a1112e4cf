"""Static-graph autodiff: ``append_backward`` / ``gradients``.

Counterpart of ``paddle_tpu/static/backward.py`` (reference:
``python/paddle/fluid/backward.py``, grad OpDescs made op by op). As in
the JAX package there is no grad-op synthesis: ``append_backward`` only
declares grad Variables (placeholders the Executor fills) and marks the
loss; the Executor differentiates the replay with
``torch.autograd.grad``. ``static_minimize`` registers the optimizer,
whose update the Executor applies after the backward.
"""
from __future__ import annotations

from typing import List, Tuple

from .program import Variable


def _grad_var_for(ref, program) -> Variable:
    blk = program.global_block()
    base = (getattr(ref, "name", None) or f"param_{id(ref)}") + "@GRAD"
    name = program._unique_name(base)
    if isinstance(ref, Variable):
        fake, desc = ref._fake, ref.desc_shape
    else:
        fake, desc = program._fake_of(ref), None
    v = Variable(blk, fake, name, "grad", desc)
    blk.vars[name] = v
    return v


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None) -> List[Tuple[object, Variable]]:
    """Declare grads of ``loss`` w.r.t. parameters; returns ``[(param,
    grad_var)]``. ``parameter_list`` may hold Parameters (the usual
    case: layers make them) or data Variables."""
    if not isinstance(loss, Variable):
        raise TypeError("append_backward expects a static Variable loss")
    prog = loss.program
    if parameter_list is None:
        parameter_list = prog.all_parameters()
    no_grad = {id(t) for t in (no_grad_set or [])}
    refs = []
    for p in parameter_list:
        if id(p) in no_grad:
            continue
        if isinstance(p, Variable) or not p.stop_gradient:
            refs.append(p)
    pairs = [(ref, _grad_var_for(ref, prog)) for ref in refs]
    prog._version += 1
    if prog._backward is not None:
        old_loss, old_pairs = prog._backward
        if old_loss is not loss:
            raise ValueError("append_backward already called with another "
                             "loss")
        known = {id(r) for r, _ in old_pairs}
        pairs = old_pairs + [pg for pg in pairs if id(pg[0]) not in known]
    prog._backward = (loss, pairs)
    return pairs


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Grads of ``sum(targets)`` w.r.t. ``inputs`` (params or data
    Variables)."""
    tgt = targets[0] if isinstance(targets, (list, tuple)) else targets
    if isinstance(targets, (list, tuple)) and len(targets) > 1:
        acc = targets[0].sum()
        for t in targets[1:]:
            acc = acc + t.sum()
        tgt = acc
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    pairs = append_backward(tgt, parameter_list=list(inputs),
                            no_grad_set=no_grad_set)
    by_id = {id(r): g for r, g in pairs}
    out = []
    for i in inputs:
        if id(i) not in by_id:
            raise ValueError(
                f"gradients(): input {getattr(i, 'name', i)!r} is not "
                "differentiable (stop_gradient=True and not a Variable)")
        out.append(by_id[id(i)])
    return out


def static_minimize(optimizer, loss: Variable, parameters=None):
    """``Optimizer.minimize`` on a static loss: register the update
    (the reference appends sgd/adam ops; the Executor applies the
    optimizer's ``_apply`` after the backward)."""
    prog = loss.program
    params = parameters
    if params is None:
        params = optimizer._parameter_list or None
    if params is None:
        params = [p for p in prog.all_parameters() if not p.stop_gradient]
    params = [p for p in params if not p.stop_gradient]
    if not optimizer._parameter_list:
        optimizer._parameter_list = list(params)
    pairs = append_backward(loss, parameter_list=params)
    prog._opt = (optimizer, pairs)
    prog._version += 1
    return None, pairs
