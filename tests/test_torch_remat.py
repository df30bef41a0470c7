"""Activation recompute in the port: ``distributed.fleet.utils.recompute``
and ``models.apply_llama_remat`` against the JAX package's and against
the port without remat.

- A tiny Llama (float32, the JAX weights) with ``apply_llama_remat``: the
  loss and every gradient EQUAL to the same model without remat (the
  same operations replayed on the CPU: bit for bit); 5 steps of
  ``compile_train_step`` with AdamW(1e-3) beside the JAX package's
  ``recompute=True`` + ``apply_llama_remat`` train step: losses within
  1e-4 (float32 products in other orders, as in ``test_torch_train.py``);
  the KV-cache path (``generate``) untouched: the same tokens.
- ``recompute`` of a small MLP beside the JAX package's eager
  ``recompute``: outputs and gradients within 1e-5 absolute and relative
  (float32 products of width 8 and 16 summed in other orders, values up
  to ~10).
- Dropout under ``recompute`` replays its mask: a block with ``F.dropout``
  (the port's default generator) and one with the bdrln op (its seed from
  the port's CPU generator) give gradients EQUAL to the same block run
  without recompute from the same generator state, and the generators
  end where the plain run leaves them; with ``preserve_rng_state=False``
  the replay draws a new mask and the gradients differ (so the test can
  see a lost replay).
"""

import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.fleet.utils import recompute as jrecompute
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import apply_llama_remat as japply

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.jit import compile_train_step
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     apply_llama_remat)
from paddle_tpu_torch.nn import functional as F

torch.set_num_threads(1)


def _jax_llama():
    cfg = JaxLlamaConfig.tiny()
    cfg.recompute = True
    paddle.seed(0)
    return JaxLlama(cfg)


def _port_llama(jm):
    cfg = LlamaConfig.tiny()
    cfg.recompute = True
    return weights.from_paddle_tpu_state(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()},
        LlamaForCausalLM(cfg, device="cpu"))


def _batch():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 128, (2, 16))
    lab = rng.integers(0, 128, (2, 16))
    lab[0, :3] = -100
    return torch.from_numpy(ids), torch.from_numpy(lab)


def test_llama_remat_gradients_equal_no_remat():
    plain = _port_llama(_jax_llama())
    remat = apply_llama_remat(copy.deepcopy(plain))
    ids, lab = _batch()
    losses = []
    for m in (plain, remat):
        m.train()
        loss = m(ids, labels=lab)
        loss.backward()
        losses.append(loss.item())
    assert losses[0] == losses[1]
    for (n, a), (_, b) in zip(plain.named_parameters(),
                              remat.named_parameters()):
        assert torch.equal(a.grad, b.grad), n


def test_llama_remat_train_steps_match_jax():
    jm = _jax_llama()
    tm = apply_llama_remat(_port_llama(jm))
    japply(jm)
    ids, lab = _batch()
    loss_fn = lambda m, i, l: m(i, labels=l)  # noqa: E731
    jstep = jjit.compile_train_step(
        jm, loss_fn, jopt.AdamW(1e-3, parameters=jm.parameters()))
    tstep = compile_train_step(
        tm, loss_fn, topt.AdamW(1e-3, parameters=tm.parameters()))
    jl = [float(jstep(paddle.to_tensor(ids.numpy()),
                      paddle.to_tensor(lab.numpy()))) for _ in range(5)]
    tl = [float(tstep(ids, lab)) for _ in range(5)]
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    assert tl[-1] < tl[0]


def test_remat_leaves_the_kv_cache_path_alone():
    plain = _port_llama(_jax_llama())
    remat = apply_llama_remat(copy.deepcopy(plain))
    prompt = torch.tensor([[3, 1, 4, 1, 5, 9]])
    for use_cache in (True, False):
        assert torch.equal(
            plain.generate(prompt, 6, use_cache=use_cache),
            remat.generate(prompt, 6, use_cache=use_cache))


def test_recompute_mlp_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w1 = rng.standard_normal((8, 16)).astype(np.float32)
    w2 = rng.standard_normal((16, 8)).astype(np.float32)

    jx = paddle.to_tensor(x, stop_gradient=False)
    jw1 = paddle.to_tensor(w1, stop_gradient=False)
    jw2 = paddle.to_tensor(w2, stop_gradient=False)
    jout = jrecompute(lambda a: paddle.matmul(
        paddle.tanh(paddle.matmul(a, jw1)), jw2), jx)
    jout.sum().backward()

    tx = torch.from_numpy(x).requires_grad_()
    tw1 = torch.from_numpy(w1).requires_grad_()
    tw2 = torch.from_numpy(w2).requires_grad_()
    tout = recompute(lambda a: torch.tanh(a @ tw1) @ tw2, tx)
    tout.sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                               rtol=1e-5, atol=1e-5)
    for t, j in ((tx, jx), (tw1, jw1), (tw2, jw2)):
        np.testing.assert_allclose(t.grad.numpy(), j.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert recompute(lambda a: a * 2, tx).grad_fn is None


def _dropout_block(w):
    def block(x):
        return F.dropout(torch.tanh(x @ w), p=0.5) @ w.t()
    return block


def _bdrln_block(w, ln_w):
    def block(x):
        return TIF.fused_bias_dropout_residual_layer_norm(
            x @ w, x, ln_scale=ln_w, dropout_rate=0.3)
    return block


@pytest.mark.parametrize("kind", ["dropout", "bdrln"])
def test_dropout_under_recompute_replays_its_mask(kind):
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
    ln0 = torch.ones(8)

    def run(wrap, **kw):
        prandom.seed(123)
        x = x0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        ln = ln0.clone().requires_grad_()
        block = _dropout_block(w) if kind == "dropout" else \
            _bdrln_block(w, ln)
        out = wrap(block, x, **kw)
        # a draw between forward and backward must not leak into the replay
        F.dropout(torch.ones(16), p=0.5)
        (out * torch.arange(out.numel()).reshape(out.shape)).sum().backward()
        after = prandom.get_rng_state()
        return [x.grad, w.grad, ln.grad], after

    plain, plain_after = run(lambda f, *a: f(*a))
    kept, kept_after = run(recompute)
    for a, b in zip(plain, kept):
        assert (a is None and b is None) or torch.equal(a, b)
    assert plain_after.keys() == kept_after.keys()
    for dev in plain_after:
        assert torch.equal(plain_after[dev], kept_after[dev])
    lost, _ = run(recompute, preserve_rng_state=False)
    assert not all(torch.equal(a, b) for a, b in zip(plain[:2], lost[:2]))
