"""The port's model zoo (``paddle_tpu_torch.vision.models``) against the
JAX package's, on the CPU: for every class and factory of the JAX
``vision.models``, the parameter and buffer names and shapes equal the
JAX model's (built with ``fast_jax_init``), and the port's forward at the
smallest input the model takes (2 images; 8x8 but where the topology
needs more) is finite and of the right shape in training and in eval
mode. ``test_torch_vision_zoo_parity.py`` holds the forwards of one
model of each topology to the JAX package's values.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.vision import models as jm

from paddle_tpu_torch.vision import models as tm
from torch_parity import cpu_device  # noqa: F401
from torch_vision_parity import (fast_jax_init,  # noqa: F401
                                 names_and_shapes, port_forward_modes)

torch.set_num_threads(1)

FACTORIES = [
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
    "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
    "resnext152_32x4d", "resnext152_64x4d", "vgg11", "vgg13", "vgg16",
    "vgg19", "alexnet", "mobilenet_v1", "mobilenet_v2",
    "mobilenet_v3_large", "mobilenet_v3_small", "densenet121",
    "densenet161", "densenet169", "densenet201", "densenet264",
    "shufflenet_v2_x0_25", "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
    "shufflenet_v2_swish", "squeezenet1_0", "squeezenet1_1", "googlenet",
    "inception_v3"]
# the smallest square input each topology takes (8 where not listed)
SMALLEST = {"vgg": 32, "alexnet": 63, "densenet": 29, "squeezenet1_0": 35,
            "squeezenet1_1": 31, "googlenet": 189, "inception_v3": 75}


def smallest(name):
    return next((v for k, v in SMALLEST.items() if name.startswith(k)), 8)


def test_every_jax_name_is_on_the_port():
    public = {n for n in dir(jm) if not n.startswith("_")}
    assert public - {"resnet", "small", "extra", "variants"} <= set(dir(tm))
    assert set(FACTORIES) | {"LeNet"} <= public


@pytest.mark.parametrize("name", FACTORIES)
def test_factory_names_shapes_and_forward(name, fast_jax_init):  # noqa: F811
    j = getattr(jm, name)(num_classes=10)
    t = getattr(tm, name)(num_classes=10)
    assert names_and_shapes(t) == names_and_shapes(j)
    hw = smallest(name)
    x = np.random.default_rng(0).standard_normal((2, 3, hw, hw)).astype(
        np.float32)
    port_forward_modes(t, x, (2, 10))


def test_lenet_and_headless_models(fast_jax_init):  # noqa: F811
    t = tm.LeNet()
    assert names_and_shapes(t) == names_and_shapes(jm.LeNet())
    port_forward_modes(t, np.zeros((2, 1, 28, 28), np.float32), (2, 10))
    for name, shape in (("resnet18", (2, 512, 1, 1)),
                        ("mobilenet_v2", (2, 1280, 1, 1))):
        t = getattr(tm, name)(num_classes=0)
        assert names_and_shapes(t) == names_and_shapes(
            getattr(jm, name)(num_classes=0))
        port_forward_modes(t, np.ones((2, 3, 8, 8), np.float32), shape)
    t = tm.resnet18(num_classes=10, with_pool=False)
    with pytest.raises(RuntimeError):      # no pool: fc meets [N, 512 * 4]
        t(torch.ones(2, 3, 64, 64))
