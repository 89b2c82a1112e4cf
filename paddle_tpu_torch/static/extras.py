"""The static API's tail (counterpart of ``paddle_tpu/static/extras.py``):
places, guards, parameters and global variables, the strategy bags and
``ParallelExecutor``, ``Print`` and ``py_func``, ``exponential_decay``,
the static ``accuracy`` / ``auc`` / ``ctr_metric_bundle``,
``ExponentialMovingAverage``, program and persistable serialization and
``static.save`` / ``load``.

Reference: ``python/paddle/static/__init__.py`` re-exports from
``fluid/framework.py`` (places, guards), ``static/io.py`` (serialize /
deserialize / save / load), ``fluid/optimizer.py
ExponentialMovingAverage``, ``fluid/layers/metric_op.py`` (accuracy /
auc). Places are ``torch.device``s. ``serialize_program`` records the
port's op names, which are the torch-level calls its recorder saw
(``linear``, ``relu``, ``sequence_pool`` ...), not the JAX package's.
Parameters are keyed in saved state by their ``name`` where they have
one, else ``param_<i>`` in the program's first-use order.
"""
from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch

from ..core.dispatch import recordable
from ..core.tensor import from_numpy, to_numpy, to_tensor, to_tensor_arg

__all__ = [
    "BuildStrategy", "ExecutionStrategy", "ExponentialMovingAverage",
    "IpuCompiledProgram", "IpuStrategy", "ParallelExecutor", "Print",
    "WeightNormParamAttr", "accuracy", "auc", "cpu_places",
    "create_global_var", "create_parameter", "ctr_metric_bundle",
    "cuda_places", "deserialize_persistables", "deserialize_program",
    "device_guard", "exponential_decay", "ipu_shard_guard", "load",
    "load_from_file", "load_program_state", "mlu_places", "name_scope",
    "normalize_program", "npu_places", "py_func", "save", "save_to_file",
    "serialize_persistables", "serialize_program", "set_ipu_shard",
    "set_program_state", "xpu_places", "batch_norm",
]


# --------------------------------------------------------------- places ---


def cpu_places(device_count=None):
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [torch.device("cpu") for _ in range(n)]


def cuda_places(device_ids=None):
    """The CUDA devices (``device_ids`` of them), or one CPU place on a
    machine without any."""
    ids = (list(device_ids) if device_ids is not None
           else list(range(torch.cuda.device_count())))
    return [torch.device("cuda", i) for i in ids] or cpu_places(1)


def xpu_places(device_ids=None):
    raise RuntimeError("XPU devices are not present in a CUDA deployment")


def npu_places(device_ids=None):
    raise RuntimeError("NPU devices are not present in a CUDA deployment")


def mlu_places(device_ids=None):
    raise RuntimeError("MLU devices are not present in a CUDA deployment")


# --------------------------------------------------------------- guards ---


@contextlib.contextmanager
def name_scope(prefix=None):
    """Reference ``framework.name_scope``: the prefix names a range in
    ``torch.profiler`` traces (the JAX package's ``jax.named_scope``)."""
    with torch.profiler.record_function(prefix or "scope"):
        yield


@contextlib.contextmanager
def device_guard(device=None):
    """Accepted and inert: the recorder places each op on its inputs'
    device."""
    yield


@contextlib.contextmanager
def ipu_shard_guard(index=-1, stage=-1):
    raise RuntimeError("IPU support is not compiled in")
    yield  # pragma: no cover


def set_ipu_shard(call_func, index=-1, stage=-1):
    raise RuntimeError("IPU support is not compiled in")


class IpuStrategy:
    def __init__(self):
        raise RuntimeError("IPU support is not compiled in")


class IpuCompiledProgram:
    def __init__(self, *a, **k):
        raise RuntimeError("IPU support is not compiled in")


# ---------------------------------------------------------- param utils ---


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A Parameter on the current device (zeros for a bias, else
    Xavier-uniform, unless ``default_initializer``); in static mode it
    joins the startup program."""
    from ..core.dtypes import convert_dtype
    from .nn import _param

    p = _param(shape, default_initializer, is_bias, convert_dtype(dtype))
    if name:
        p.name = name
    return p


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    t = to_tensor(np.full(tuple(shape), value, dtype),
                  place="cpu" if force_cpu else None)
    if name:
        t.name = name
    return t


class WeightNormParamAttr:
    """Reference ``WeightNormParamAttr``: a parameter attribute asking
    for the weight-norm reparameterisation, carried as metadata."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.trainable = trainable


# ------------------------------------------------------------- strategies --


class BuildStrategy:
    """An accepted attribute bag (the reference's ``BuildStrategy`` steers
    its SSA graph builder, which has no counterpart here)."""

    def __init__(self):
        self.__dict__["_d"] = {}

    def __setattr__(self, k, v):
        self._d[k] = v

    def __getattr__(self, k):
        return self.__dict__.get("_d", {}).get(k, None)


class ExecutionStrategy(BuildStrategy):
    pass


class ParallelExecutor:
    """The deprecated facade (reference ``compiler.py``): runs
    ``main_program`` through an ``Executor``."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        from .executor import Executor

        self._exe = Executor()
        self._program = main_program

    def run(self, fetch_list=None, feed=None, return_numpy=True):
        return self._exe.run(self._program, feed=feed,
                             fetch_list=fetch_list,
                             return_numpy=return_numpy)


# ------------------------------------------------------------------- ops ---


def Print(input, first_n=-1, message=None, summarize=20,  # noqa: A002,N802
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """The reference ``Print`` op: prints ``"<message>: <value>"`` and
    passes the value on. A static program records it, and it prints at
    every run."""
    msg = message or "var"

    @recordable("print", lambda x: torch.empty_like(x))
    def run(x):
        print(f"{msg}: {x}")
        return x

    return run(to_tensor_arg(input))


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    from .nn import py_func as _pf

    return _pf(func, x, out, backward_func, skip_vars_in_backward_input)


def batch_norm(*args, **kwargs):
    from .nn import batch_norm as _bn

    return _bn(*args, **kwargs)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """The legacy schedule (reference ``fluid/layers/
    learning_rate_scheduler.py``) as an ``LRScheduler``: ``lr *
    decay_rate ** (step / decay_steps)``, the exponent floored with
    ``staircase``."""
    from ..optimizer.lr import LRScheduler

    class _ExpStep(LRScheduler):
        def get_lr(self):
            e = self.last_epoch / decay_steps
            if staircase:
                e = int(e)
            return self.base_lr * (decay_rate ** e)

    return _ExpStep(learning_rate)


# ----------------------------------------------------------------- metric --


@recordable("accuracy", lambda x, y, k: x.new_empty((), dtype=torch.float32))
def _accuracy(x, y, k):
    topk = torch.argsort(-x, dim=-1)[:, :k]
    hit = torch.any(topk == y.reshape(-1, 1), dim=-1)
    return torch.mean(hit.float())


def accuracy(input, label, k=1, correct=None, total=None,  # noqa: A002
             name=None):
    """Top-k accuracy (reference ``metric_op.py accuracy``), a float32
    scalar on the input's device."""
    return _accuracy(to_tensor_arg(input), to_tensor_arg(label), k=k)


def _scores(x):
    return x[:, 1] if x.ndim == 2 and x.shape[1] == 2 else x.reshape(-1)


@recordable("auc", lambda x, y, n: x.new_empty((), dtype=torch.float32))
def _auc(x, y, n):
    p = _scores(x)
    yv = y.reshape(-1).float()
    bins = torch.clamp((p * n).to(torch.int32), 0, n).long()
    zeros = torch.zeros(n + 1, dtype=torch.float32, device=x.device)
    pos = zeros.index_add(0, bins, yv)
    neg = zeros.index_add(0, bins, 1.0 - yv)
    # sweep the thresholds from high to low
    tp = torch.cumsum(pos.flip(0), 0)
    fp = torch.cumsum(neg.flip(0), 0)
    tpr = torch.cat([zeros[:1], tp / torch.clamp(tp[-1], min=1e-6)])
    fpr = torch.cat([zeros[:1], fp / torch.clamp(fp[-1], min=1e-6)])
    return torch.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,  # noqa: A002
        slide_steps=1, ins_tag_weight=None):
    """Batch AUC by thresholded true/false positive counts (reference
    ``auc_op``); returns ``(auc, [])``."""
    return _auc(to_tensor_arg(input), to_tensor_arg(label),
                n=num_thresholds), []


def _ctr_infer(x, y):
    return tuple(x.new_empty((), dtype=torch.float32) for _ in range(6))


@recordable("ctr_metrics", _ctr_infer)
def _ctr(x, y):
    p = _scores(x)
    yv = y.reshape(-1).float()
    return (torch.sum((p - yv) ** 2), torch.sum(torch.abs(p - yv)),
            torch.sum(p), torch.sum(p), torch.sum(yv),
            torch.tensor(float(p.shape[0]), device=x.device))


def ctr_metric_bundle(input, label, ins_tag_weight=None):  # noqa: A002
    """CTR metrics (reference ``ctr_metric_bundle``): ``(auc, sqrerr,
    abserr, prob, q, pos, total)``."""
    a, _ = auc(input, label)
    return (a, *_ctr(to_tensor_arg(input), to_tensor_arg(label)))


# ---------------------------------------------------------------- EMA -----


class ExponentialMovingAverage:
    """EMA of the trainable parameters (reference ``fluid/optimizer.py
    ExponentialMovingAverage``): ``update()`` after each step keeps
    float32 shadows ``decay * ema + (1 - decay) * p``; ``apply()`` (a
    context manager) puts the bias-corrected shadows ``ema / (1 -
    decay ** steps)`` into the parameters, cast to their dtypes, and
    ``restore()`` puts the parameters' own values back, bit for bit."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._ema = {}
        self._backup = {}
        self._step = 0

    @torch.no_grad()
    def update(self, parameters=None):
        from .program import default_main_program

        params = parameters or [
            p for p in default_main_program().all_parameters()
            if p.requires_grad]
        self._step += 1
        for p in params:
            v = self._ema.get(id(p))
            arr = p.detach().float()
            if v is None:
                self._ema[id(p)] = (p, arr.clone())
            else:
                self._ema[id(p)] = (p, self._decay * v[1]
                                    + (1 - self._decay) * arr)

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        with torch.no_grad():
            self._backup = {k: (p, p.detach().clone())
                            for k, (p, _) in self._ema.items()}
            corr = 1.0 - self._decay ** max(self._step, 1)
            for p, v in self._ema.values():
                # a true division, as the JAX package's (a CUDA tensor
                # over a Python scalar is a multiply by its reciprocal)
                den = torch.tensor(corr, dtype=torch.float32,
                                   device=v.device)
                p.copy_(torch.div(v, den).to(p.dtype))
        try:
            yield self
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        for p, v in self._backup.values():
            p.copy_(v)
        self._backup = {}


# -------------------------------------------------- program serialization --


def _param_key(i, p) -> str:
    return getattr(p, "name", None) or f"param_{i}"


def _program_state(program):
    return {_param_key(i, p): to_numpy(p)
            for i, p in enumerate(program.all_parameters())}


def serialize_program(feed_vars=None, fetch_vars=None, program=None,
                      **kwargs):
    """The program's outline, pickled: its parameter and op counts and
    its op names (the port recorder's, torch-level)."""
    from .program import default_main_program

    program = program or default_main_program()
    meta = {
        "n_params": len(program.all_parameters()),
        "n_ops": len(program.ops),
        "op_names": [r.op_name for r in program.ops],
    }
    return pickle.dumps(meta)


def deserialize_program(data):
    return pickle.loads(data)


def serialize_persistables(feed_vars=None, fetch_vars=None, program=None,
                           **kwargs):
    """The program's parameters as a pickle of numpy arrays (bfloat16 as
    its exact float32 values)."""
    from .program import default_main_program

    return pickle.dumps(_program_state(program or default_main_program()))


def deserialize_persistables(program, data, executor=None):
    state = pickle.loads(data)
    set_program_state(program, state)
    return state


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def save(program, model_path, protocol=4, **configs):
    """Reference ``static/io.py save``: ``<path>.pdparams`` (the
    parameters) and ``<path>.pdmodel`` (the program's outline)."""
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump(_program_state(program), f, protocol=protocol)
    with open(model_path + ".pdmodel", "wb") as f:
        f.write(serialize_program(program=program))


def load(program, model_path, executor=None, var_list=None):
    with open(model_path + ".pdparams", "rb") as f:
        state = pickle.load(f)
    set_program_state(program, state)


def load_program_state(model_path, var_list=None):
    with open(model_path + ".pdparams", "rb") as f:
        return pickle.load(f)


@torch.no_grad()
def set_program_state(program, state_dict):
    """Copy ``state_dict`` (key -> array) into the program's parameters,
    each keeping its dtype and device."""
    for i, p in enumerate(program.all_parameters()):
        key = _param_key(i, p)
        if key in state_dict:
            p.copy_(from_numpy(state_dict[key]).to(p.device, p.dtype))


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """Reference ``static/io.py normalize_program``: the Executor prunes
    each run to its fetches, so the program is returned as it is."""
    return program
