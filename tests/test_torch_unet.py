"""The port's diffusion UNet (``paddle_tpu_torch.models.unet``) against
the JAX package's (``paddle_tpu/models/unet.py``), on the CPU, with the
JAX model's weights carried across by ``weights.from_paddle_tpu_state``.

- the tiny UNet's forward: the same output within 1e-5 of its largest
  value (float32; GroupNorm, convolutions and attention summed in other
  orders);
- ``ddpm_loss`` on the same inputs within 1e-5 relative;
- 6 ``compile_train_step`` AdamW steps (lr 2e-3): the losses equal JAX's
  to rtol 1e-4, and fall;
- timestep conditioning: two timesteps give different outputs, as
  ``tests/test_unet.py`` asserts;
- the full-size configuration's parameter count (12,625,604, the JAX
  model's) and the tiny model's parameter names;
- importing the UNet and the new ``nn`` and ``ops`` modules loads
  neither ``jax`` nor ``paddle_tpu`` (a fresh interpreter).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import jit as jjit
from paddle_tpu.models import unet as junet

from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import unet as tunet
from torch_parity import cpu_device  # noqa: F401

torch.set_num_threads(1)


def _pair(seed=0):
    paddle.seed(seed)
    jm = junet.UNet2DModel(junet.UNetConfig.tiny())
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    tm = weights.from_paddle_tpu_state(
        arrays, tunet.UNet2DModel(tunet.UNetConfig.tiny(), device="cpu"))
    return jm, tm


def _batch(n=4, seed=1):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, 3, 16, 16)).astype(np.float32),
            r.integers(0, 1000, (n,)).astype(np.int64),
            r.standard_normal((n, 3, 16, 16)).astype(np.float32))


def _close(got, want, rel=1e-5):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def test_tiny_unet_forward_matches_jax():
    jm, tm = _pair()
    x, t, _ = _batch()
    jm.eval()
    tm.eval()
    with paddle.no_grad():
        want = jm(paddle.to_tensor(x), paddle.to_tensor(t)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (4, 3, 16, 16)
    _close(got, want)
    emb_t = tunet.timestep_embedding(torch.from_numpy(t), 64).numpy()
    emb_j = junet.timestep_embedding(paddle.to_tensor(t), 64).numpy()
    np.testing.assert_allclose(emb_t, emb_j, rtol=1e-6, atol=1e-6)


def test_ddpm_loss_matches_jax():
    jm, tm = _pair()
    x0, t, noise = _batch()
    want = float(junet.ddpm_loss(jm, *map(paddle.to_tensor,
                                          (x0, t, noise))).numpy())
    got = float(tunet.ddpm_loss(tm, *map(torch.from_numpy, (x0, t, noise))))
    assert got == pytest.approx(want, rel=1e-5)


def test_six_adamw_train_steps_match_jax():
    jm, tm = _pair()
    x0, t, noise = _batch()
    jo = jopt.AdamW(2e-3, parameters=jm.parameters())
    to = topt.AdamW(2e-3, parameters=tm.parameters())
    jstep = jjit.compile_train_step(
        jm, lambda m, a, b, c: junet.ddpm_loss(m, a, b, c), jo)
    tstep = tjit.compile_train_step(
        tm, lambda m, a, b, c: tunet.ddpm_loss(m, a, b, c), to)
    jargs = [paddle.to_tensor(v) for v in (x0, t, noise)]
    targs = [torch.from_numpy(v) for v in (x0, t, noise)]
    want = [float(jstep(*jargs).numpy()) for _ in range(6)]
    got = [float(tstep(*targs)) for _ in range(6)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_timestep_conditioning_matters():
    _, tm = _pair()
    tm.eval()
    x = torch.from_numpy(_batch(1)[0])
    with torch.no_grad():
        a = tm(x, torch.tensor([0]))
        b = tm(x, torch.tensor([999]))
    assert not torch.allclose(a, b)


def test_full_size_parameter_count():
    """UNetConfig() at full width: 12,625,604 parameters (the JAX model's
    count); the tiny model's names equal the JAX model's."""
    tm = tunet.UNet2DModel(tunet.UNetConfig(), device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == 12625604
    jm, tiny = _pair()
    assert sorted(n for n, _ in tiny.named_parameters()) == \
        sorted(n for n, _ in jm.named_parameters())


def test_new_modules_import_no_jax():
    code = (
        "import json, sys\n"
        "import paddle_tpu_torch as p\n"
        "import paddle_tpu_torch.models.unet\n"
        "import paddle_tpu_torch.nn.functional.conv\n"
        "import paddle_tpu_torch.nn.functional.pooling\n"
        "import paddle_tpu_torch.nn.functional.common\n"
        "import paddle_tpu_torch.nn.functional.loss\n"
        "import paddle_tpu_torch.nn.functional.norm\n"
        "import paddle_tpu_torch.nn.initializer\n"
        "import paddle_tpu_torch.nn.layer.conv\n"
        "import paddle_tpu_torch.nn.layer.norm\n"
        "import paddle_tpu_torch.ops.impl.detection\n"
        "import paddle_tpu_torch.ops.impl.misc_legacy\n"
        "import paddle_tpu_torch.ops.impl.sampling_legacy\n"
        "p.set_device('cpu')\n"
        "p.conv2d(__import__('torch').ones(1, 1, 3, 3),"
        " __import__('torch').ones(1, 1, 2, 2))\n"
        "print(json.dumps(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
