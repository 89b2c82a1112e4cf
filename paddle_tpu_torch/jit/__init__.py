"""``paddle.jit``: ``to_static`` (CUDA graphs per signature), dy2static,
``save`` / ``load`` through ``torch.export``, and the train step."""
from .dy2static import ProgramTranslator  # noqa: F401
from .to_static import (StaticFunction, TrainStep, TranslatedLayer,
                        load, not_to_static, save, to_static)

__all__ = ["TrainStep", "StaticFunction", "TranslatedLayer", "to_static",
           "not_to_static", "save", "load", "ProgramTranslator",
           "set_code_level", "set_verbosity"]


def set_code_level(level=100, also_to_stdout=False):
    """Reference ``jit/api.py set_code_level``: the dy2static code-logging
    level (stored)."""
    from . import dy2static

    dy2static._code_level = level


def set_verbosity(level=0, also_to_stdout=False):
    from . import dy2static

    dy2static._verbosity = level
