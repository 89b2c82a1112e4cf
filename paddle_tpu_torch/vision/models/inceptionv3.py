"""Inception-v3 (counterpart of ``paddle_tpu/vision/models/inceptionv3.py``;
reference: ``python/paddle/vision/models/inceptionv3.py``). Its
``AvgPool2D(3, 1, 1)`` is ``exclusive`` (PyTorch's
``count_include_pad=False``), the Paddle default."""
from __future__ import annotations

from ... import nn
from ...ops import concat

__all__ = ["InceptionV3", "inception_v3"]


class ConvBN(nn.Sequential):
    def __init__(self, in_c, out_c, k, stride=1, padding=0):
        super().__init__(
            nn.Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                      bias_attr=False),
            nn.BatchNorm2D(out_c), nn.ReLU(),
        )


class InceptionA(nn.Layer):
    def __init__(self, in_c, pool_features):
        super().__init__()
        self.b1 = ConvBN(in_c, 64, 1)
        self.b5 = nn.Sequential(ConvBN(in_c, 48, 1), ConvBN(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(ConvBN(in_c, 64, 1), ConvBN(64, 96, 3, padding=1),
                                ConvBN(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                ConvBN(in_c, pool_features, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)], axis=1)


class InceptionB(nn.Layer):  # grid reduction
    def __init__(self, in_c):
        super().__init__()
        self.b3 = ConvBN(in_c, 384, 3, stride=2)
        self.b3d = nn.Sequential(ConvBN(in_c, 64, 1), ConvBN(64, 96, 3, padding=1),
                                 ConvBN(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class InceptionC(nn.Layer):
    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = ConvBN(in_c, 192, 1)
        self.b7 = nn.Sequential(
            ConvBN(in_c, c7, 1),
            ConvBN(c7, c7, (1, 7), padding=(0, 3)),
            ConvBN(c7, 192, (7, 1), padding=(3, 0)),
        )
        self.b7d = nn.Sequential(
            ConvBN(in_c, c7, 1),
            ConvBN(c7, c7, (7, 1), padding=(3, 0)),
            ConvBN(c7, c7, (1, 7), padding=(0, 3)),
            ConvBN(c7, c7, (7, 1), padding=(3, 0)),
            ConvBN(c7, 192, (1, 7), padding=(0, 3)),
        )
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                ConvBN(in_c, 192, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)], axis=1)


class InceptionD(nn.Layer):  # grid reduction
    def __init__(self, in_c):
        super().__init__()
        self.b3 = nn.Sequential(ConvBN(in_c, 192, 1), ConvBN(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            ConvBN(in_c, 192, 1),
            ConvBN(192, 192, (1, 7), padding=(0, 3)),
            ConvBN(192, 192, (7, 1), padding=(3, 0)),
            ConvBN(192, 192, 3, stride=2),
        )
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class InceptionE(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = ConvBN(in_c, 320, 1)
        self.b3_1 = ConvBN(in_c, 384, 1)
        self.b3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.bd_1 = nn.Sequential(ConvBN(in_c, 448, 1),
                                  ConvBN(448, 384, 3, padding=1))
        self.bd_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.bd_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                ConvBN(in_c, 192, 1))

    def forward(self, x):
        b3 = self.b3_1(x)
        b3 = concat([self.b3_2a(b3), self.b3_2b(b3)], axis=1)
        bd = self.bd_1(x)
        bd = concat([self.bd_2a(bd), self.bd_2b(bd)], axis=1)
        return concat([self.b1(x), b3, bd, self.bp(x)], axis=1)


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            ConvBN(3, 32, 3, stride=2), ConvBN(32, 32, 3),
            ConvBN(32, 64, 3, padding=1), nn.MaxPool2D(3, stride=2),
            ConvBN(64, 80, 1), ConvBN(80, 192, 3), nn.MaxPool2D(3, stride=2),
        )
        self.blocks = nn.Sequential(
            InceptionA(192, 32), InceptionA(256, 64), InceptionA(288, 64),
            InceptionB(288),
            InceptionC(768, 128), InceptionC(768, 160), InceptionC(768, 160),
            InceptionC(768, 192),
            InceptionD(768),
            InceptionE(1280), InceptionE(2048),
        )
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.2)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    return InceptionV3(**kwargs)
