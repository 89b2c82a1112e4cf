"""ShuffleNetV2 (counterpart of
``paddle_tpu/vision/models/shufflenetv2.py``; reference:
``python/paddle/vision/models/shufflenetv2.py``): ``channel_shuffle`` is
reshape, transpose, reshape; ``shufflenet_v2_swish`` uses ``nn.Swish``."""
from __future__ import annotations

from ... import nn
from ...ops import concat, reshape, transpose

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]


def channel_shuffle(x, groups):
    n, c, h, w = x.shape
    x = reshape(x, [n, groups, c // groups, h, w])
    x = transpose(x, [0, 2, 1, 3, 4])
    return reshape(x, [n, c, h, w])


def _act(name):
    return nn.Swish() if name == "swish" else nn.ReLU()


class ConvBNAct(nn.Sequential):
    def __init__(self, in_c, out_c, k, stride=1, groups=1, act="relu"):
        layers = [
            nn.Conv2D(in_c, out_c, k, stride=stride, padding=(k - 1) // 2,
                      groups=groups, bias_attr=False),
            nn.BatchNorm2D(out_c),
        ]
        if act is not None:
            layers.append(_act(act))
        super().__init__(*layers)


class InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, act="relu"):
        super().__init__()
        self.stride = stride
        branch = out_c // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                ConvBNAct(in_c // 2, branch, 1, act=act),
                ConvBNAct(branch, branch, 3, stride=1, groups=branch, act=None),
                ConvBNAct(branch, branch, 1, act=act),
            )
        else:
            self.branch1 = nn.Sequential(
                ConvBNAct(in_c, in_c, 3, stride=stride, groups=in_c, act=None),
                ConvBNAct(in_c, branch, 1, act=act),
            )
            self.branch2 = nn.Sequential(
                ConvBNAct(in_c, branch, 1, act=act),
                ConvBNAct(branch, branch, 3, stride=stride, groups=branch,
                          act=None),
                ConvBNAct(branch, branch, 1, act=act),
            )

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            x1 = x[:, :c]
            x2 = x[:, c:]
            out = concat([x1, self.branch2(x2)], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Layer):
    _STAGE_OUT = {
        0.25: (24, 24, 48, 96, 512), 0.33: (24, 32, 64, 128, 512),
        0.5: (24, 48, 96, 192, 1024), 1.0: (24, 116, 232, 464, 1024),
        1.5: (24, 176, 352, 704, 1024), 2.0: (24, 244, 488, 976, 2048),
    }

    def __init__(self, scale=1.0, act="relu", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        c0, c1, c2, c3, c_last = self._STAGE_OUT[scale]
        self.conv1 = ConvBNAct(3, c0, 3, stride=2, act=act)
        self.pool1 = nn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        in_c = c0
        for out_c, repeat in ((c1, 4), (c2, 8), (c3, 4)):
            stage = [InvertedResidual(in_c, out_c, 2, act)]
            stage += [InvertedResidual(out_c, out_c, 1, act)
                      for _ in range(repeat - 1)]
            stages.append(nn.Sequential(*stage))
            in_c = out_c
        self.stage2, self.stage3, self.stage4 = stages
        self.conv5 = ConvBNAct(in_c, c_last, 1, act=act)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(c_last, num_classes)

    def forward(self, x):
        x = self.pool1(self.conv1(x))
        x = self.stage4(self.stage3(self.stage2(x)))
        x = self.conv5(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.25, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.33, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.5, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.5, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=2.0, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, act="swish", **kwargs)
