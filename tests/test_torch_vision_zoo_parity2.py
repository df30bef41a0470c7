"""The zoo's parity (see ``test_torch_vision_zoo_parity.py``), continued:
MobileNetV2 (inverted residuals), MobileNetV3 small (squeeze-excite,
hardswish) and DenseNet-121.
"""

import pytest
import torch

from torch_parity import cpu_device  # noqa: F401
from torch_vision_parity import check_zoo_model, fast_jax_init  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["densenet121", "mobilenet_v2",
                                  "mobilenet_v3_small"])
def test_forward_matches_jax_in_float64(name, fast_jax_init):  # noqa: F811
    check_zoo_model(name)
