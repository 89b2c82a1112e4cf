"""``paddle.static``: the static-graph (program) API.

Counterpart of ``paddle_tpu/static/__init__.py``: record a Program
(``program.py``: a torch-level recorder over fake tensors), replay it
with the ``Executor`` (``executor.py``), differentiate it
(``backward.py``), build it from ``static.nn`` helpers and control flow,
and export it (``io.py``: ``save_inference_model`` through
``torch.export``). ``static/sequence.py`` and ``static/extras.py`` of
the JAX package are not ported yet.
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

__all__ = [
    "append_backward", "gradients", "CompiledProgram", "Executor", "Scope",
    "global_scope", "scope_guard", "load_inference_model",
    "save_inference_model", "ExportedProgram", "InputSpec", "Program",
    "Variable", "Block", "OpRecord", "data", "default_main_program",
    "default_startup_program", "program_guard", "enable_static",
    "disable_static", "in_dynamic_mode", "in_static_mode", "nn",
]
