"""Vision models of the port."""
from ...nn import layer_state_from_jax
from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152)

__all__ = ["LeNet", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "layer_state_from_jax"]
