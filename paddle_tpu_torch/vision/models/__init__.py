"""The model zoo: the counterpart of ``paddle_tpu/vision/models/``
(``resnet``, ``small``, ``extra``, ``variants``), every class and factory
of the JAX package. A model is built on the current device
(``set_device``: the card unless the CPU was asked for), with the
layers' own initializers drawn from the port's generators.
"""

from .resnet import (  # noqa: F401
    ResNet, BasicBlock, BottleneckBlock, resnet18, resnet34, resnet50,
    resnet101, resnet152, wide_resnet50_2, resnext50_32x4d,
)
from .small import (  # noqa: F401
    LeNet, AlexNet, alexnet, VGG, vgg11, vgg13, vgg16, vgg19, MobileNetV2,
    mobilenet_v2,
)
from .extra import (  # noqa: F401
    DenseNet, densenet121, ShuffleNetV2, shufflenet_v2_x1_0, SqueezeNet,
    squeezenet1_1,
)
from .variants import (  # noqa: F401
    resnext50_64x4d, resnext101_32x4d, resnext101_64x4d, resnext152_32x4d,
    resnext152_64x4d, wide_resnet101_2, densenet161, densenet169,
    densenet201, densenet264, squeezenet1_0, shufflenet_v2_x0_25,
    shufflenet_v2_x0_33, shufflenet_v2_x0_5, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, shufflenet_v2_swish, MobileNetV1, mobilenet_v1,
    MobileNetV3, MobileNetV3Large, MobileNetV3Small, mobilenet_v3_large,
    mobilenet_v3_small, GoogLeNet, googlenet, InceptionV3, inception_v3,
)
