"""High-level ``Model`` API (counterpart of ``paddle_tpu/hapi/model.py``).

Reference: ``python/paddle/hapi/model.py:1004`` (``fit:1696``,
``_run_one_epoch:2240``) with ``DynamicGraphAdapter``: eager steps, or
with ``prepare(jit=True)`` the port's ``jit.TrainStep``. Each training
batch's loss is read on the host (``float(loss.item())``), as in the JAX
package, so a step ends in a device sync. ``evaluate`` and ``predict``
run the network under ``no_grad`` (the numbers are the JAX package's;
no autograd graph is kept). ``summary`` and ``flops`` trace a zero
batch with a forward post-hook on every sublayer and count parameters
with ``numel()`` (a port ``Tensor``'s ``size`` is torch's method).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.tensor import to_tensor
from ..metric import Metric
from ..nn.layer.layers import Layer

__all__ = ["Model", "summary", "flops"]


class Model:
    def __init__(self, network: Layer, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._jit = False
        self._train_step = None

    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None, jit=False):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]
        self._jit = jit
        if jit and optimizer is not None and loss is not None:
            from ..jit import TrainStep

            def loss_fn(net, x, y):
                out = net(x)
                return self._loss(out, y)

            self._train_step = TrainStep(self.network, loss_fn, optimizer)
        return self

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        y = labels[0] if isinstance(labels, (list, tuple)) else labels
        if self._train_step is not None:
            loss = self._train_step(x, y)
            return [float(loss.item())]
        out = self.network(x)
        loss = self._loss(out, y)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [float(loss.item())]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        y = labels[0] if isinstance(labels, (list, tuple)) else labels
        out = self.network(x)
        loss = self._loss(out, y) if self._loss else None
        for m in self._metrics:
            m.update(m.compute(out, y))
        return [float(loss.item())] if loss is not None else []

    def predict_batch(self, inputs):
        self.network.eval()
        x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        with torch.no_grad():
            out = self.network(x)
        return out

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Reference ``hapi/model.py:1696``: epoch loop driving callbacks
        (on_train_begin/epoch/batch/eval events, early-stop support)."""
        from ..io.dataloader import DataLoader, Dataset
        from .callbacks import config_callbacks

        if isinstance(train_data, Dataset):
            loader = DataLoader(train_data, batch_size=batch_size,
                                shuffle=shuffle, drop_last=drop_last,
                                num_workers=num_workers)
        else:
            loader = train_data
        try:
            steps = len(loader)
        except TypeError:  # iterable dataset: length unknown
            steps = None
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            log_freq=log_freq, verbose=verbose, save_dir=save_dir,
            save_freq=save_freq, metrics=[m.name() for m in self._metrics])
        self.stop_training = False
        history = {"loss": []}
        step = 0
        cbks.on_train_begin()
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            epoch_losses = []
            for batch in loader:
                x, y = batch[0], batch[1]
                cbks.on_train_batch_begin(step)
                loss = self.train_batch(x, y)
                history["loss"].append(loss[0])
                epoch_losses.append(loss[0])
                logs = {"loss": loss[0]}
                cbks.on_train_batch_end(step, logs)
                step += 1
                if (num_iters is not None and step >= num_iters) or \
                        self.stop_training:
                    break
            cbks.on_epoch_end(epoch, {"loss": float(np.mean(epoch_losses))
                                      if epoch_losses else None})
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_data, batch_size=batch_size,
                              verbose=verbose, num_workers=num_workers,
                              callbacks=cbks)
            if (num_iters is not None and step >= num_iters) or \
                    self.stop_training:
                break
        cbks.on_train_end({"loss": history["loss"][-1]
                           if history["loss"] else None})
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        from ..io.dataloader import DataLoader, Dataset
        from .callbacks import CallbackList, config_callbacks

        if isinstance(eval_data, Dataset):
            loader = DataLoader(eval_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = eval_data
        if isinstance(callbacks, CallbackList):
            cbks = callbacks
        else:
            cbks = config_callbacks(callbacks, model=self, verbose=verbose,
                                    log_freq=log_freq, mode="eval")
        for m in self._metrics:
            m.reset()
        losses = []
        cbks.on_eval_begin()
        for i, batch in enumerate(loader):
            x, y = batch[0], batch[1]
            cbks.on_eval_batch_begin(i)
            out = self.eval_batch(x, y)
            losses.extend(out)
            cbks.on_eval_batch_end(i, {"loss": out[0] if out else None})
            if num_iters is not None and i + 1 >= num_iters:
                break
        res = {"loss": float(np.mean(losses)) if losses else None}
        for m in self._metrics:
            res[m.name()] = m.accumulate()
        cbks.on_eval_end(res)
        return res

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                callbacks=None, verbose=1):
        from ..io.dataloader import DataLoader, Dataset
        from .callbacks import config_callbacks

        if isinstance(test_data, Dataset):
            loader = DataLoader(test_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = test_data
        cbks = config_callbacks(callbacks, model=self, verbose=0,
                                mode="predict")
        outs = []
        cbks.on_predict_begin()
        for i, batch in enumerate(loader):
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            cbks.on_predict_batch_begin(i)
            out = self.predict_batch(x)
            outs.append(out)
            cbks.on_predict_batch_end(i)
        cbks.on_predict_end()
        if stack_outputs:
            if not outs:
                return []
            if isinstance(outs[0], (tuple, list)):
                # multi-output net: stack each output field separately
                return [torch.cat([o[i] for o in outs])
                        for i in range(len(outs[0]))]
            return [torch.cat(outs)]
        return outs

    def save(self, path, training=True):
        from ..framework.io import save as _save

        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as _load

        self.network.set_state_dict(_load(path + ".pdparams"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)


def _traced_forward(net: Layer, input_size, dtypes=None, input=None,  # noqa: A002
                    hook_for=None):
    """Forward a zero batch in eval/no-grad mode with a post-hook on every
    sublayer — the shared drive for summary's shape capture and flops."""
    handles = []
    for name, sub in net.named_sublayers(include_self=True):
        handles.append(sub.register_forward_post_hook(hook_for(name, sub)))
    try:
        if input is not None:
            xs = input if isinstance(input, (list, tuple)) else [input]
        else:
            sizes = (input_size if isinstance(input_size, list)
                     and isinstance(input_size[0], (list, tuple))
                     else [input_size])
            dts = dtypes if isinstance(dtypes, (list, tuple)) else \
                [dtypes] * len(sizes)
            xs = []
            for s, dt in zip(sizes, dts):
                s = [1 if d in (None, -1) else int(d) for d in s]
                xs.append(to_tensor(np.zeros(s, dt or "float32")))
        was_training = net.training
        net.eval()
        with torch.no_grad():
            net(*xs)
        if was_training:
            net.train()
    finally:
        for h in handles:
            h.remove()


def _run_with_shape_hooks(net: Layer, input_size, dtypes=None, input=None):  # noqa: A002
    records = []

    def hook_for(name, layer):
        def hook(l, inputs, output):
            out = output[0] if isinstance(output, (tuple, list)) else output
            shape = list(out.shape) if hasattr(out, "shape") else None
            n_params = sum(p.numel() for p in l._parameters.values()
                           if p is not None)
            records.append((name or type(l).__name__, type(l).__name__,
                            shape, n_params))

        return hook

    _traced_forward(net, input_size, dtypes, input, hook_for)
    return records


def summary(net: Layer, input_size=None, dtypes=None, input=None):  # noqa: A002
    """Reference ``hapi/model_summary.py``: layer table with output shapes
    (when input_size/input is given) + parameter counts."""
    records = []
    if input_size is not None or input is not None:
        # forward errors (e.g. a wrong input_size) propagate — silently
        # degrading to a param-only table hides the user's mistake
        records = _run_with_shape_hooks(net, input_size, dtypes, input)
    total, trainable = 0, 0
    for p in net.parameters():
        total += p.numel()
        if p.requires_grad:
            trainable += p.numel()
    lines = ["-" * 78]
    lines.append(f"{'Layer (type)':<38}{'Output Shape':<22}{'Param #':>16}")
    lines.append("=" * 78)
    if records:
        for name, kind, shape, n_params in records:
            lines.append(f"{name + ' (' + kind + ')':<38}"
                         f"{str(shape or '-'):<22}{n_params:>16,}")
    else:
        for name, p in net.named_parameters():
            lines.append(f"{name:<38}{'-':<22}{p.numel():>16,}")
    lines.append("=" * 78)
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    lines.append(f"Non-trainable params: {total - trainable:,}")
    lines.append("-" * 78)
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


def flops(net: Layer, input_size, custom_ops=None, print_detail=False) -> int:
    """Reference ``hapi/dynamic_flops.py``: per-layer FLOP estimate from a
    traced forward, one multiply-add counted as one FLOP (the
    reference's convention): a ``Linear`` ``out elements x in``, a
    ``Conv2D`` ``out elements x (in / groups) x kh x kw``, a norm ``2 x
    out elements``; ``custom_ops`` maps a layer type to its count."""
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import Conv2D
    from ..nn.layer import norm as _norm

    norm_types = tuple(getattr(_norm, n) for n in
                       ("BatchNorm1D", "BatchNorm2D", "LayerNorm")
                       if hasattr(_norm, n))
    counts = {}

    def hook_for(name, layer):
        def hook(l, inputs, output):
            x = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
            out = output[0] if isinstance(output, (tuple, list)) else output
            f = 0
            if custom_ops and type(l) in custom_ops:
                f = custom_ops[type(l)](l, x, out)
            elif isinstance(l, Linear):
                f = int(np.prod(out.shape)) * l.weight.shape[0]
            elif isinstance(l, Conv2D):
                kh_kw_cin = int(np.prod(l.weight.shape[1:]))
                f = int(np.prod(out.shape)) * kh_kw_cin
            elif norm_types and isinstance(l, norm_types):
                f = int(np.prod(out.shape)) * 2
            counts[id(l)] = counts.get(id(l), 0) + f

        return hook

    _traced_forward(net, list(input_size), hook_for=hook_for)
    total = int(sum(counts.values()))
    if print_detail:
        print(f"Total FLOPs: {total:,}")
    return total
