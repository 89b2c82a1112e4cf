"""``paddle.static``: the static-graph (program) API.

Counterpart of ``paddle_tpu/static/__init__.py``: record a Program
(``program.py``: a torch-level recorder over fake tensors), replay it
with the ``Executor`` (``executor.py``), differentiate it
(``backward.py``), build it from ``static.nn`` helpers and control flow,
export it (``io.py``: ``save_inference_model`` through
``torch.export``), run the padded-plus-length sequence ops
(``sequence.py``, also in ``static.nn``) and the static tail
(``extras.py``: places, guards, EMA, the static metrics, program and
persistable serialization, ``static.save`` / ``load``).
"""
from . import nn  # noqa: F401
from .backward import append_backward, gradients  # noqa: F401
from .executor import (CompiledProgram, Executor, Scope, global_scope,  # noqa: F401
                       scope_guard)
from .io import (ExportedProgram, load_inference_model,  # noqa: F401
                 save_inference_model)
from .program import (Block, InputSpec, OpRecord, Program, Variable,  # noqa: F401
                      data, default_main_program, default_startup_program,
                      disable_static, enable_static, in_dynamic_mode,
                      in_static_mode, program_guard)
from .extras import (  # noqa: F401
    BuildStrategy, ExecutionStrategy, ExponentialMovingAverage,
    IpuCompiledProgram, IpuStrategy, ParallelExecutor, Print,
    WeightNormParamAttr, accuracy, auc, batch_norm, cpu_places,
    create_global_var, create_parameter, ctr_metric_bundle, cuda_places,
    deserialize_persistables, deserialize_program, device_guard,
    exponential_decay, ipu_shard_guard, load, load_from_file,
    load_program_state, mlu_places, name_scope, normalize_program,
    npu_places, py_func, save, save_to_file, serialize_persistables,
    serialize_program, set_ipu_shard, set_program_state, xpu_places,
)
from .sequence import *  # noqa: F401,F403
from .sequence import __all__ as _sequence

__all__ = [
    "append_backward", "gradients", "CompiledProgram", "Executor", "Scope",
    "global_scope", "scope_guard", "load_inference_model",
    "save_inference_model", "ExportedProgram", "InputSpec", "Program",
    "Variable", "Block", "OpRecord", "data", "default_main_program",
    "default_startup_program", "program_guard", "enable_static",
    "disable_static", "in_dynamic_mode", "in_static_mode", "nn",
    "BuildStrategy", "ExecutionStrategy", "ExponentialMovingAverage",
    "IpuCompiledProgram", "IpuStrategy", "ParallelExecutor", "Print",
    "WeightNormParamAttr", "accuracy", "auc", "batch_norm", "cpu_places",
    "create_global_var", "create_parameter", "ctr_metric_bundle",
    "cuda_places", "deserialize_persistables", "deserialize_program",
    "device_guard", "exponential_decay", "ipu_shard_guard", "load",
    "load_from_file", "load_program_state", "mlu_places", "name_scope",
    "normalize_program", "npu_places", "py_func", "save", "save_to_file",
    "serialize_persistables", "serialize_program", "set_ipu_shard",
    "set_program_state", "xpu_places", *_sequence,
]
