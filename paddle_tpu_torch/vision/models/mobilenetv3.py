"""MobileNetV3 Small and Large (counterpart of
``paddle_tpu/vision/models/mobilenetv3.py``; reference:
``python/paddle/vision/models/mobilenetv3.py``). The squeeze-excitation
gate is ``nn.Hardsigmoid`` with the JAX slope 0.1666667, not 1/6; the
classifier's ``Dropout(0.2)`` runs the port's threefry dropout kernel on
the card."""
from __future__ import annotations

from ... import nn

__all__ = ["MobileNetV3Small", "MobileNetV3Large",
           "mobilenet_v3_small", "mobilenet_v3_large"]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcitation(nn.Layer):
    def __init__(self, channel, reduction=4):
        super().__init__()
        squeeze = _make_divisible(channel // reduction)
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(channel, squeeze, 1)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(squeeze, channel, 1)
        self.hsigmoid = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsigmoid(self.fc2(self.relu(self.fc1(self.avgpool(x)))))
        return x * s


def _act(name):
    return nn.Hardswish() if name == "hardswish" else nn.ReLU()


class InvertedResidual(nn.Layer):
    def __init__(self, in_c, exp, out_c, kernel, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if exp != in_c:
            layers += [nn.Conv2D(in_c, exp, 1, bias_attr=False),
                       nn.BatchNorm2D(exp), _act(act)]
        layers += [
            nn.Conv2D(exp, exp, kernel, stride=stride,
                      padding=(kernel - 1) // 2, groups=exp, bias_attr=False),
            nn.BatchNorm2D(exp), _act(act),
        ]
        if use_se:
            layers.append(SqueezeExcitation(exp))
        layers += [nn.Conv2D(exp, out_c, 1, bias_attr=False),
                   nn.BatchNorm2D(out_c)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.block(x) if self.use_res else self.block(x)


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = _make_divisible(16 * scale)
        layers = [nn.Conv2D(3, in_c, 3, stride=2, padding=1, bias_attr=False),
                  nn.BatchNorm2D(in_c), nn.Hardswish()]
        for k, exp, c, se, act, s in cfg:
            out_c = _make_divisible(c * scale)
            exp_c = _make_divisible(exp * scale)
            layers.append(InvertedResidual(in_c, exp_c, out_c, k, s, se, act))
            in_c = out_c
        last_conv = _make_divisible(6 * in_c)
        layers += [nn.Conv2D(in_c, last_conv, 1, bias_attr=False),
                   nn.BatchNorm2D(last_conv), nn.Hardswish()]
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_conv, last_channel), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_channel, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class MobileNetV3Small(_MobileNetV3):
    CFG = [  # k, exp, c, se, act, s
        (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
        (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
        (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
        (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
        (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
        (5, 576, 96, True, "hardswish", 1),
    ]

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(self.CFG, 1024, scale, num_classes, with_pool)


class MobileNetV3Large(_MobileNetV3):
    CFG = [
        (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
        (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
        (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
        (3, 240, 80, False, "hardswish", 2),
        (3, 200, 80, False, "hardswish", 1),
        (3, 184, 80, False, "hardswish", 1),
        (3, 184, 80, False, "hardswish", 1),
        (3, 480, 112, True, "hardswish", 1),
        (3, 672, 112, True, "hardswish", 1),
        (5, 672, 160, True, "hardswish", 2),
        (5, 960, 160, True, "hardswish", 1),
        (5, 960, 160, True, "hardswish", 1),
    ]

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(self.CFG, 1280, scale, num_classes, with_pool)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Large(scale=scale, **kwargs)
