"""Optimizers of the port."""
from .optimizer import Adam, AdamW, Momentum, Optimizer

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW"]
