"""One model of each topology of the zoo: the port's forward against the
JAX package's in float64 with the port's weights carried into the JAX
model (``torch_vision_parity.check_zoo_model``: training mode with
dropout off, then eval mode; 1e-9 relative and absolute; 4 images of the
size in ``PARITY_SIZE``). ResNet (basic and bottleneck blocks) is held in
``test_torch_vision.py``; this file holds the grouped bottleneck
(ResNeXt), AlexNet, VGG, MobileNetV1 (depthwise), SqueezeNet 1.0 and 1.1
and ShuffleNetV2 (relu and swish); ``test_torch_vision_zoo_parity2.py``
MobileNetV2 and V3 and DenseNet; ``..._parity3.py`` GoogLeNet (with its
two auxiliary heads) and InceptionV3.
"""

import pytest
import torch

from torch_parity import cpu_device  # noqa: F401
from torch_vision_parity import check_zoo_model, fast_jax_init  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("name", [
    "alexnet", "mobilenet_v1", "resnext50_32x4d", "shufflenet_v2_swish",
    "shufflenet_v2_x0_25", "squeezenet1_0", "squeezenet1_1", "vgg11"])
def test_forward_matches_jax_in_float64(name, fast_jax_init):  # noqa: F811
    check_zoo_model(name)
