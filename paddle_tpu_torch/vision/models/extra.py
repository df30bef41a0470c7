"""DenseNet, ShuffleNetV2 and SqueezeNet: the counterpart of
``paddle_tpu/vision/models/extra.py``, the same topologies and names on
the port's ``nn``.
"""

from __future__ import annotations

import torch

from ... import nn


class _DenseLayer(nn.Layer):
    def __init__(self, in_c, growth_rate, bn_size):
        super().__init__()
        mid = bn_size * growth_rate
        self.block = nn.Sequential(
            nn.BatchNorm2D(in_c), nn.ReLU(),
            nn.Conv2D(in_c, mid, 1, bias_attr=False),
            nn.BatchNorm2D(mid), nn.ReLU(),
            nn.Conv2D(mid, growth_rate, 3, padding=1, bias_attr=False))

    def forward(self, x):
        return torch.cat([x, self.block(x)], dim=1)


class _Transition(nn.Layer):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.block = nn.Sequential(
            nn.BatchNorm2D(in_c), nn.ReLU(),
            nn.Conv2D(in_c, out_c, 1, bias_attr=False),
            nn.AvgPool2D(2, 2))

    def forward(self, x):
        return self.block(x)


class DenseNet(nn.Layer):
    def __init__(self, layers=121, growth_rate=32, bn_size=4,
                 num_classes=1000, with_pool=True):
        super().__init__()
        cfg = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
               169: (6, 12, 32, 32), 201: (6, 12, 48, 32),
               264: (6, 12, 64, 48)}[layers]
        num_init = 2 * growth_rate
        self.stem = nn.Sequential(
            nn.Conv2D(3, num_init, 7, stride=2, padding=3, bias_attr=False),
            nn.BatchNorm2D(num_init), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1))
        blocks = []
        c = num_init
        for i, n in enumerate(cfg):
            for _ in range(n):
                blocks.append(_DenseLayer(c, growth_rate, bn_size))
                c += growth_rate
            if i != len(cfg) - 1:
                blocks.append(_Transition(c, c // 2))
                c = c // 2
        self.features = nn.Sequential(*blocks)
        self.norm = nn.BatchNorm2D(c)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(c, num_classes)

    def forward(self, x):
        x = torch.relu(self.norm(self.features(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def densenet121(pretrained=False, **kw):
    return DenseNet(121, **kw)


class _ShuffleUnit(nn.Layer):
    def __init__(self, in_c, out_c, stride, act_cls=None):
        super().__init__()
        act_cls = act_cls or nn.ReLU
        self.stride = stride
        branch_c = out_c // 2
        if stride == 2:
            self.branch1 = nn.Sequential(
                nn.Conv2D(in_c, in_c, 3, stride=2, padding=1, groups=in_c,
                          bias_attr=False),
                nn.BatchNorm2D(in_c),
                nn.Conv2D(in_c, branch_c, 1, bias_attr=False),
                nn.BatchNorm2D(branch_c), act_cls())
            b2_in = in_c
        else:
            self.branch1 = None
            b2_in = in_c // 2
        self.branch2 = nn.Sequential(
            nn.Conv2D(b2_in, branch_c, 1, bias_attr=False),
            nn.BatchNorm2D(branch_c), act_cls(),
            nn.Conv2D(branch_c, branch_c, 3, stride=stride, padding=1,
                      groups=branch_c, bias_attr=False),
            nn.BatchNorm2D(branch_c),
            nn.Conv2D(branch_c, branch_c, 1, bias_attr=False),
            nn.BatchNorm2D(branch_c), act_cls())
        self.shuffle = nn.ChannelShuffle(2)

    def forward(self, x):
        if self.stride == 2:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        else:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        return self.shuffle(out)


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 act="relu"):
        super().__init__()
        stage_out = {0.25: (24, 48, 96, 512), 0.33: (32, 64, 128, 512),
                     0.5: (48, 96, 192, 1024), 1.0: (116, 232, 464, 1024),
                     1.5: (176, 352, 704, 1024),
                     2.0: (244, 488, 976, 2048)}[scale]
        act_cls = {"relu": nn.ReLU, "swish": nn.Swish}[act]
        self.stem = nn.Sequential(
            nn.Conv2D(3, 24, 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(24), act_cls(), nn.MaxPool2D(3, 2, padding=1))
        stages = []
        in_c = 24
        for out_c, repeats in zip(stage_out[:3], (4, 8, 4)):
            stages.append(_ShuffleUnit(in_c, out_c, 2, act_cls))
            for _ in range(repeats - 1):
                stages.append(_ShuffleUnit(out_c, out_c, 1, act_cls))
            in_c = out_c
        self.stages = nn.Sequential(*stages)
        self.head_conv = nn.Sequential(
            nn.Conv2D(in_c, stage_out[3], 1, bias_attr=False),
            nn.BatchNorm2D(stage_out[3]), act_cls())
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(stage_out[3], num_classes)

    def forward(self, x):
        x = self.head_conv(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return ShuffleNetV2(1.0, **kw)


class _Fire(nn.Layer):
    def __init__(self, in_c, squeeze_c, e1, e3):
        super().__init__()
        self.squeeze = nn.Sequential(nn.Conv2D(in_c, squeeze_c, 1), nn.ReLU())
        self.expand1 = nn.Sequential(nn.Conv2D(squeeze_c, e1, 1), nn.ReLU())
        self.expand3 = nn.Sequential(nn.Conv2D(squeeze_c, e3, 3, padding=1),
                                     nn.ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return torch.cat([self.expand1(s), self.expand3(s)], dim=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.1", num_classes=1000, with_pool=True):
        super().__init__()
        if version == "1.0":
            # ref squeezenet v1.0: 7x7/96 stem, pools after fire 3 and 7
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128),
                nn.MaxPool2D(3, 2),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, 2),
                _Fire(512, 64, 256, 256))
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, 2),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, 2),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU(),
            nn.AdaptiveAvgPool2D(1))

    def forward(self, x):
        return torch.flatten(self.classifier(self.features(x)), 1)


def squeezenet1_1(pretrained=False, **kw):
    return SqueezeNet("1.1", **kw)
