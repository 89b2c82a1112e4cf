"""Vision models of the port."""
from ...nn import layer_state_from_jax
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "layer_state_from_jax"]
