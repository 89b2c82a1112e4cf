"""DenseNet (counterpart of ``paddle_tpu/vision/models/densenet.py``;
reference: ``python/paddle/vision/models/densenet.py``); ``dropout`` is
optional (0 builds no dropout layer)."""
from __future__ import annotations

from ... import nn
from ...ops import concat

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_ARCH = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class DenseLayer(nn.Layer):
    def __init__(self, in_c, growth_rate, bn_size, dropout):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(in_c)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(in_c, bn_size * growth_rate, 1, bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        y = self.conv1(self.relu(self.bn1(x)))
        y = self.conv2(self.relu(self.bn2(y)))
        if self.dropout is not None:
            y = self.dropout(y)
        return concat([x, y], axis=1)


class DenseBlock(nn.Sequential):
    def __init__(self, num_layers, in_c, growth_rate, bn_size, dropout):
        layers = [
            DenseLayer(in_c + i * growth_rate, growth_rate, bn_size, dropout)
            for i in range(num_layers)
        ]
        super().__init__(*layers)


class Transition(nn.Sequential):
    def __init__(self, in_c, out_c):
        super().__init__(
            nn.BatchNorm2D(in_c), nn.ReLU(),
            nn.Conv2D(in_c, out_c, 1, bias_attr=False),
            nn.AvgPool2D(2, stride=2),
        )


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        num_init, growth, block_cfg = _ARCH[layers]
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, num_init, 7, stride=2, padding=3, bias_attr=False),
            nn.BatchNorm2D(num_init), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1),
        )
        blocks = []
        c = num_init
        for i, n in enumerate(block_cfg):
            blocks.append(DenseBlock(n, c, growth, bn_size, dropout))
            c += n * growth
            if i != len(block_cfg) - 1:
                blocks.append(Transition(c, c // 2))
                c //= 2
        blocks += [nn.BatchNorm2D(c), nn.ReLU()]
        self.features = nn.Sequential(*blocks)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(c, num_classes)

    def forward(self, x):
        x = self.features(self.conv1(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def densenet121(pretrained=False, **kwargs):
    return DenseNet(121, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return DenseNet(161, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return DenseNet(169, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return DenseNet(201, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return DenseNet(264, **kwargs)
