"""Optimizers of the port."""
from . import lr
from .offload import HostOffloadAdamW
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Lars, Momentum, Optimizer, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "Adamax", "RMSProp", "Lamb", "Lars",
           "HostOffloadAdamW"]
