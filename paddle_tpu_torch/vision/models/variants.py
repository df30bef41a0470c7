"""The rest of the model zoo: the counterpart of
``paddle_tpu/vision/models/variants.py`` — the ResNeXt and wide ResNet
factories, the DenseNet, SqueezeNet 1.0 and ShuffleNet variants,
MobileNetV1, MobileNetV3 (large and small), GoogLeNet (returning the
main and the two auxiliary logits) and InceptionV3, on the port's
``nn``.
"""

from __future__ import annotations

import torch

from ... import nn
from ...nn import functional as F
from .resnet import ResNet, BottleneckBlock
from .extra import DenseNet, ShuffleNetV2, SqueezeNet


# ---------------- resnext / wide resnet factories --------------------------

def resnext50_64x4d(pretrained=False, **kw):
    return ResNet(BottleneckBlock, 50, width=4, groups=64, **kw)


def resnext101_32x4d(pretrained=False, **kw):
    return ResNet(BottleneckBlock, 101, width=4, groups=32, **kw)


def resnext101_64x4d(pretrained=False, **kw):
    return ResNet(BottleneckBlock, 101, width=4, groups=64, **kw)


def resnext152_32x4d(pretrained=False, **kw):
    return ResNet(BottleneckBlock, 152, width=4, groups=32, **kw)


def resnext152_64x4d(pretrained=False, **kw):
    return ResNet(BottleneckBlock, 152, width=4, groups=64, **kw)


def wide_resnet101_2(pretrained=False, **kw):
    return ResNet(BottleneckBlock, 101, width=128, **kw)


# ---------------- densenet / squeezenet / shufflenet factories -------------

def densenet161(pretrained=False, **kw):
    return DenseNet(161, growth_rate=48, **kw)


def densenet169(pretrained=False, **kw):
    return DenseNet(169, **kw)


def densenet201(pretrained=False, **kw):
    return DenseNet(201, **kw)


def densenet264(pretrained=False, **kw):
    return DenseNet(264, **kw)


def squeezenet1_0(pretrained=False, **kw):
    return SqueezeNet("1.0", **kw)


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return ShuffleNetV2(scale=0.25, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return ShuffleNetV2(scale=0.33, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return ShuffleNetV2(scale=0.5, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return ShuffleNetV2(scale=1.5, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return ShuffleNetV2(scale=2.0, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    return ShuffleNetV2(scale=1.0, act="swish", **kw)


# ---------------- MobileNetV1 ---------------------------------------------

class MobileNetV1(nn.Layer):
    """ref: vision/models/mobilenetv1.py — depthwise-separable stack."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale), 8)

        def dw_sep(in_c, out_c, stride):
            return nn.Sequential(
                nn.Conv2D(in_c, in_c, 3, stride=stride, padding=1,
                          groups=in_c, bias_attr=False),
                nn.BatchNorm2D(in_c), nn.ReLU(),
                nn.Conv2D(in_c, out_c, 1, bias_attr=False),
                nn.BatchNorm2D(out_c), nn.ReLU())

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + \
              [(512, 512, 1)] * 5 + [(512, 1024, 2), (1024, 1024, 1)]
        layers = [nn.Conv2D(3, c(32), 3, stride=2, padding=1,
                            bias_attr=False),
                  nn.BatchNorm2D(c(32)), nn.ReLU()]
        for in_c, out_c, s in cfg:
            layers.append(dw_sep(c(in_c), c(out_c), s))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.fc(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    return MobileNetV1(scale=scale, **kw)


# ---------------- MobileNetV3 ---------------------------------------------

class _SE(nn.Layer):
    def __init__(self, ch, r=4):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(ch, ch // r, 1)
        self.fc2 = nn.Conv2D(ch // r, ch, 1)

    def forward(self, x):
        s = self.fc2(F.relu(self.fc1(self.pool(x))))
        return x * F.hardsigmoid(s)


class _MBV3Block(nn.Layer):
    def __init__(self, in_c, exp_c, out_c, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if exp_c != in_c:
            layers += [nn.Conv2D(in_c, exp_c, 1, bias_attr=False),
                       nn.BatchNorm2D(exp_c), act()]
        layers += [nn.Conv2D(exp_c, exp_c, k, stride=stride,
                             padding=k // 2, groups=exp_c,
                             bias_attr=False),
                   nn.BatchNorm2D(exp_c), act()]
        if use_se:
            layers.append(_SE(exp_c))
        layers += [nn.Conv2D(exp_c, out_c, 1, bias_attr=False),
                   nn.BatchNorm2D(out_c)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_MBV3_LARGE = [
    # k, exp, out, se, act, stride
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hs", 2), (3, 200, 80, False, "hs", 1),
    (3, 184, 80, False, "hs", 1), (3, 184, 80, False, "hs", 1),
    (3, 480, 112, True, "hs", 1), (3, 672, 112, True, "hs", 1),
    (5, 672, 160, True, "hs", 2), (5, 960, 160, True, "hs", 1),
    (5, 960, 160, True, "hs", 1),
]

_MBV3_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hs", 2),
    (5, 240, 40, True, "hs", 1), (5, 240, 40, True, "hs", 1),
    (5, 120, 48, True, "hs", 1), (5, 144, 48, True, "hs", 1),
    (5, 288, 96, True, "hs", 2), (5, 576, 96, True, "hs", 1),
    (5, 576, 96, True, "hs", 1),
]


class MobileNetV3(nn.Layer):
    """ref: vision/models/mobilenetv3.py."""

    def __init__(self, config, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale + 4) // 8 * 8, 8)

        act_of = {"relu": nn.ReLU, "hs": nn.Hardswish}
        stem_c = c(16)
        layers = [nn.Conv2D(3, stem_c, 3, stride=2, padding=1,
                            bias_attr=False),
                  nn.BatchNorm2D(stem_c), nn.Hardswish()]
        in_c = stem_c
        for k, exp, out, se, act, s in config:
            layers.append(_MBV3Block(in_c, c(exp), c(out), k, s, se,
                                     act_of[act]))
            in_c = c(out)
        last_conv = c(config[-1][1])
        layers += [nn.Conv2D(in_c, last_conv, 1, bias_attr=False),
                   nn.BatchNorm2D(last_conv), nn.Hardswish()]
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_conv, last_channel), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_channel, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.classifier(x)
        return x


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_MBV3_LARGE, 1280, scale, num_classes, with_pool)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_MBV3_SMALL, 1024, scale, num_classes, with_pool)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kw):
    return MobileNetV3Large(scale=scale, **kw)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kw):
    return MobileNetV3Small(scale=scale, **kw)


# ---------------- GoogLeNet / InceptionV3 ---------------------------------

class _ConvBN(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride,
                              padding=padding, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class _Inception(nn.Layer):
    """GoogLeNet inception block."""

    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _ConvBN(in_c, c1, 1)
        self.b2 = nn.Sequential(_ConvBN(in_c, c3r, 1),
                                _ConvBN(c3r, c3, 3, padding=1))
        self.b3 = nn.Sequential(_ConvBN(in_c, c5r, 1),
                                _ConvBN(c5r, c5, 5, padding=2))
        self.b4 = nn.Sequential(nn.MaxPool2D(3, 1, padding=1),
                                _ConvBN(in_c, proj, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x),
                          self.b4(x)], dim=1)


class GoogLeNet(nn.Layer):
    """ref: vision/models/googlenet.py (aux heads omitted in eval path;
    returns (out, aux1, aux2) like the reference)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.stem = nn.Sequential(
            _ConvBN(3, 64, 7, stride=2, padding=3), nn.MaxPool2D(3, 2),
            _ConvBN(64, 64, 1), _ConvBN(64, 192, 3, padding=1),
            nn.MaxPool2D(3, 2))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, 2)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, 2)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            # aux towers pool 13x13 -> 3x3 at 224 input (ref
            # googlenet.py:187-189 _pool_o1/_pool_o2)
            self.aux_pool = nn.AvgPool2D(5, stride=3)
            # ref googlenet.py:192-208: main drop 0.4; aux = 1x1 conv(128)
            # -> Linear(1152, 1024) -> drop 0.7 -> Linear(1024, nc)
            self.drop = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes)
            self.aux_conv1 = _ConvBN(512, 128, 1)
            self.aux_fc1a = nn.Linear(1152, 1024)
            self.aux_drop1 = nn.Dropout(0.7)
            self.aux_fc1 = nn.Linear(1024, num_classes)
            self.aux_conv2 = _ConvBN(528, 128, 1)
            self.aux_fc2a = nn.Linear(1152, 1024)
            self.aux_drop2 = nn.Dropout(0.7)
            self.aux_fc2 = nn.Linear(1024, num_classes)

    def _aux_head(self, x, conv, fc_a, drop, fc):
        x = conv(self.aux_pool(x))
        x = torch.flatten(x, 1)
        x = F.relu(fc_a(x))
        return fc(drop(x))

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        aux1 = x
        x = self.i4c(self.i4b(x))
        x = self.i4d(x)
        aux2 = x
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            out = self.fc(self.drop(x))
            a1 = self._aux_head(aux1, self.aux_conv1, self.aux_fc1a,
                                self.aux_drop1, self.aux_fc1)
            a2 = self._aux_head(aux2, self.aux_conv2, self.aux_fc2a,
                                self.aux_drop2, self.aux_fc2)
            return out, a1, a2
        return x


def googlenet(pretrained=False, **kw):
    return GoogLeNet(**kw)


class _InceptionA(nn.Layer):
    def __init__(self, in_c, pool_c):
        super().__init__()
        self.b1 = _ConvBN(in_c, 64, 1)
        self.b2 = nn.Sequential(_ConvBN(in_c, 48, 1),
                                _ConvBN(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_ConvBN(in_c, 64, 1),
                                _ConvBN(64, 96, 3, padding=1),
                                _ConvBN(96, 96, 3, padding=1))
        self.b4 = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _ConvBN(in_c, pool_c, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x),
                          self.b4(x)], dim=1)


class _InceptionB(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = _ConvBN(in_c, 384, 3, stride=2)
        self.b2 = nn.Sequential(_ConvBN(in_c, 64, 1),
                                _ConvBN(64, 96, 3, padding=1),
                                _ConvBN(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.pool(x)], dim=1)


class _InceptionC(nn.Layer):
    """ref: inceptionv3.py:236 — factorized 7x7 branches, 768 -> 768."""

    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = _ConvBN(in_c, 192, 1)
        self.b2 = nn.Sequential(
            _ConvBN(in_c, c7, 1),
            _ConvBN(c7, c7, (1, 7), padding=(0, 3)),
            _ConvBN(c7, 192, (7, 1), padding=(3, 0)))
        self.b3 = nn.Sequential(
            _ConvBN(in_c, c7, 1),
            _ConvBN(c7, c7, (7, 1), padding=(3, 0)),
            _ConvBN(c7, c7, (1, 7), padding=(0, 3)),
            _ConvBN(c7, c7, (7, 1), padding=(3, 0)),
            _ConvBN(c7, 192, (1, 7), padding=(0, 3)))
        self.b4 = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _ConvBN(in_c, 192, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x),
                          self.b4(x)], dim=1)


class _InceptionD(nn.Layer):
    """ref: inceptionv3.py:342 — grid reduction, 768 -> 1280."""

    def __init__(self, in_c):
        super().__init__()
        self.b1 = nn.Sequential(_ConvBN(in_c, 192, 1),
                                _ConvBN(192, 320, 3, stride=2))
        self.b2 = nn.Sequential(
            _ConvBN(in_c, 192, 1),
            _ConvBN(192, 192, (1, 7), padding=(0, 3)),
            _ConvBN(192, 192, (7, 1), padding=(3, 0)),
            _ConvBN(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.pool(x)], dim=1)


class _InceptionE(nn.Layer):
    """ref: inceptionv3.py — split 3x3 branches, -> 2048."""

    def __init__(self, in_c):
        super().__init__()
        self.b1 = _ConvBN(in_c, 320, 1)
        self.b2_stem = _ConvBN(in_c, 384, 1)
        self.b2_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b2_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.b3_stem = nn.Sequential(_ConvBN(in_c, 448, 1),
                                     _ConvBN(448, 384, 3, padding=1))
        self.b3_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.b4 = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _ConvBN(in_c, 192, 1))

    def forward(self, x):
        b2 = self.b2_stem(x)
        b3 = self.b3_stem(x)
        return torch.cat([
            self.b1(x),
            torch.cat([self.b2_a(b2), self.b2_b(b2)], dim=1),
            torch.cat([self.b3_a(b3), self.b3_b(b3)], dim=1),
            self.b4(x)], dim=1)


class InceptionV3(nn.Layer):
    """ref: vision/models/inceptionv3.py — full stem + A(x3)/B/C(x4)/D/E(x2)
    tower ending at 2048-dim pooled features, as the reference builds."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _ConvBN(3, 32, 3, stride=2), _ConvBN(32, 32, 3),
            _ConvBN(32, 64, 3, padding=1), nn.MaxPool2D(3, 2),
            _ConvBN(64, 80, 1), _ConvBN(80, 192, 3), nn.MaxPool2D(3, 2))
        self.a1 = _InceptionA(192, 32)
        self.a2 = _InceptionA(256, 64)
        self.a3 = _InceptionA(288, 64)
        self.b = _InceptionB(288)
        self.c1 = _InceptionC(768, 128)
        self.c2 = _InceptionC(768, 160)
        self.c3 = _InceptionC(768, 160)
        self.c4 = _InceptionC(768, 192)
        self.d = _InceptionD(768)
        self.e1 = _InceptionE(1280)
        self.e2 = _InceptionE(2048)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.a3(self.a2(self.a1(x)))
        x = self.b(x)
        x = self.c4(self.c3(self.c2(self.c1(x))))
        x = self.d(x)
        x = self.e2(self.e1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.fc(self.dropout(x))
        return x


def inception_v3(pretrained=False, **kw):
    return InceptionV3(**kw)
