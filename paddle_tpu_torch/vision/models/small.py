"""LeNet, AlexNet, VGG and MobileNetV2: the counterpart of
``paddle_tpu/vision/models/small.py``, the same topologies and names on
the port's ``nn``.
"""

from __future__ import annotations

import torch

from ... import nn


class LeNet(nn.Layer):
    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120), nn.Linear(120, 84),
                nn.Linear(84, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.fc(x)
        return x


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2))
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Linear(256 * 36, 4096), nn.ReLU(),
            nn.Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(torch.flatten(x, 1))


_VGG_CFG = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
         "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
         512, "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        return self.classifier(torch.flatten(x, 1))


def _make_vgg_layers(cfg, batch_norm=False):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


def vgg11(pretrained=False, batch_norm=False, **kw):
    return VGG(_make_vgg_layers(_VGG_CFG[11], batch_norm), **kw)


def vgg13(pretrained=False, batch_norm=False, **kw):
    return VGG(_make_vgg_layers(_VGG_CFG[13], batch_norm), **kw)


def vgg16(pretrained=False, batch_norm=False, **kw):
    return VGG(_make_vgg_layers(_VGG_CFG[16], batch_norm), **kw)


def vgg19(pretrained=False, batch_norm=False, **kw):
    return VGG(_make_vgg_layers(_VGG_CFG[19], batch_norm), **kw)


class _InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers += [nn.Conv2D(inp, hidden, 1, bias_attr=False),
                       nn.BatchNorm2D(hidden), nn.ReLU6()]
        layers += [
            nn.Conv2D(hidden, hidden, 3, stride=stride, padding=1,
                      groups=hidden, bias_attr=False),
            nn.BatchNorm2D(hidden), nn.ReLU6(),
            nn.Conv2D(hidden, oup, 1, bias_attr=False),
            nn.BatchNorm2D(oup)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = int(32 * scale)
        features = [nn.Conv2D(3, in_c, 3, stride=2, padding=1,
                              bias_attr=False),
                    nn.BatchNorm2D(in_c), nn.ReLU6()]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                features.append(_InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t))
                in_c = out_c
        last = int(1280 * max(1.0, scale))
        features += [nn.Conv2D(in_c, last, 1, bias_attr=False),
                     nn.BatchNorm2D(last), nn.ReLU6()]
        self.features = nn.Sequential(*features)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(nn.Dropout(0.2),
                                            nn.Linear(last, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.classifier(x)
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kw):
    return MobileNetV2(scale=scale, **kw)


def alexnet(pretrained=False, **kw):
    return AlexNet(**kw)
