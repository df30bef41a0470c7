"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version in ``paddle_tpu_torch.ops.kernels`` (the path a
CPU tensor takes through the kernel wrappers) gets the same numpy inputs as
the Pallas kernel, run in interpret mode as the JAX package's own tests run
it: ``rms_norm_pallas(x, w, eps, True)``, ``swiglu_pallas(g, u, True)``,
``paged_decode_attention(..., interpret=True)`` and
``ragged_paged_attention(..., interpret=True)``. The attention cases cover
MHA and GQA, contexts ending mid-page and on a page boundary, block-table
entries past the context that point at real (garbage) pages, decode,
prefill-at-tail, padded and dummy ragged rows, and an idle decode slot.

Tolerance: float32, atol 2e-5 / rtol 1e-5 — the two sides sum the same
float32 products in different orders (einsum vs. online softmax over
pages), which moves the last few bits of values of order 1.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas.decode_attention import paged_decode_attention
from paddle_tpu.ops.pallas.fused_ffn import swiglu_pallas
from paddle_tpu.ops.pallas.norms import rms_norm_pallas
from paddle_tpu.ops.pallas.ragged_attention import ragged_paged_attention

from paddle_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _pools(rng, n_pages, page, h_kv, d):
    return _f32(rng, (n_pages, page, h_kv, d)), _f32(rng, (n_pages, page,
                                                            h_kv, d))


@pytest.mark.parametrize("shape", [(6, 40), (2, 3, 64)])
def test_rms_norm_plain_matches_pallas(shape):
    rng = np.random.default_rng(0)
    x = _f32(rng, shape)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    ref = rms_norm_pallas(jnp.asarray(x), jnp.asarray(w), 1e-6, True)
    _close(K.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6), ref)


@pytest.mark.parametrize("shape", [(6, 48), (2, 3, 40)])
def test_swiglu_plain_matches_pallas(shape):
    rng = np.random.default_rng(1)
    g, u = _f32(rng, shape), _f32(rng, shape)
    ref = swiglu_pallas(jnp.asarray(g), jnp.asarray(u), True)
    _close(K.swiglu(torch.from_numpy(g), torch.from_numpy(u)), ref)


# decode: (context length, pages listed in the table) per sequence; the
# table lists real pages past the context, which masking must ignore
DECODE_CASES = {
    "mid_page": [(9, 4), (3, 2), (14, 4)],
    "page_aligned": [(8, 3), (16, 4), (4, 4)],
    "idle_slot": [(0, 2), (11, 3), (1, 1)],
}


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_paged_decode_plain_matches_pallas(case, h_kv):
    rng = np.random.default_rng(2)
    h, d, page, p_max, n_pages = 4, 16, 4, 5, 16
    rows = DECODE_CASES[case]
    kp, vp = _pools(rng, n_pages, page, h_kv, d)
    bt = np.zeros((len(rows), p_max), np.int32)
    for i, (_, n_listed) in enumerate(rows):
        bt[i, :n_listed] = rng.choice(np.arange(1, n_pages), n_listed,
                                      replace=False)
    ctx = np.array([c for c, _ in rows], np.int32)
    q = _f32(rng, (len(rows), h, d))
    ref = paged_decode_attention(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(bt),
                                 jnp.asarray(ctx), interpret=True)
    port = K.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(ctx))
    _close(port, ref)


# ragged rows: (context length, q_len, pages listed, dummy)
RAGGED_CASES = {
    # a chunk at the tail of a cached prefix, ending mid-page; a decode
    # row; a first chunk shorter than Q_max (padded query rows); a dummy
    "mixed": [(13, 8, 5, False), (10, 1, 3, False), (3, 3, 2, False),
              (1, 1, 0, True)],
    # every row a full Q_max chunk, one ending on a page boundary
    "prefill": [(8, 8, 3, False), (16, 8, 5, False), (11, 8, 3, False),
                (9, 8, 4, False)],
    # all decode rows (q_len 1), contexts of different lengths
    "decode_rows": [(1, 1, 1, False), (17, 1, 5, False), (6, 1, 2, False),
                    (1, 1, 0, True)],
}


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_plain_matches_pallas(case, h_kv):
    rng = np.random.default_rng(3)
    h, d, page, p_max, n_pages, q_max = 4, 16, 4, 5, 24, 8
    rows = RAGGED_CASES[case]
    kp, vp = _pools(rng, n_pages, page, h_kv, d)
    bt = np.zeros((len(rows), p_max), np.int32)   # dummy rows: trash page
    for i, (_, _, n_listed, _) in enumerate(rows):
        bt[i, :n_listed] = rng.choice(np.arange(1, n_pages), n_listed,
                                      replace=False)
    ctx = np.array([r[0] for r in rows], np.int32)
    ql = np.array([r[1] for r in rows], np.int32)
    q = _f32(rng, (len(rows), q_max, h, d))
    ref = ragged_paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(bt),
                                 jnp.asarray(ctx), jnp.asarray(ql),
                                 interpret=True)
    port = K.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(ctx), torch.from_numpy(ql))
    _close(port, ref)
    for i, (_, n, _, _) in enumerate(rows):      # padded query rows are 0
        assert float(port[i, n:].abs().sum()) == 0.0


def test_wrappers_take_the_plain_path_only_on_cpu():
    """A CPU tensor takes the plain version and bumps no launch counter;
    a tensor on any other device is refused, never computed plainly."""
    K.reset_launch_counts()
    x = torch.ones(2, 8)
    K.rms_norm(x, torch.ones(8))
    K.swiglu(x, x)
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
    with pytest.raises(ValueError, match="meta"):
        K.swiglu(x.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        K.rms_norm(x.to("meta"), torch.ones(8, device="meta"))
