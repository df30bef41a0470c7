"""The split-K decode algorithm against the JAX package's Pallas decode
kernels.

The port's paged decode kernel (``csrc/decode_attention.cuh``) splits each
sequence's pages into ranges of ``pages_per_split``, computes a partial
(running max, normalizer, accumulator) per range and merges them.
``paged_decode_attention_split_plain`` and its int8 twin are that
algorithm in plain PyTorch. Here they get the same numpy inputs as
``paged_decode_attention(..., interpret=True)`` and
``paged_decode_attention_int8(..., interpret=True)``, with MHA and GQA
(rep 2), float and int8 pages (random codes in [-127, 127], random
per-page scales), and contexts that end mid-page, exactly on a split
boundary, inside the first split, at 0 (an idle slot: live slots are
compared, and the idle slot's output must be exactly 0), and at the full
table, whose width P is no multiple of pages_per_split (a short last
range). Block-table entries past each context point at real pages with
garbage, which masking must ignore.

Tolerance: float32, atol 1e-5 / rtol 1e-5 -- the two sides sum the same
float32 products in another order (per range, then merged, against the
Pallas kernel's page-by-page online softmax), which moves the last bits of
values of order 1.

``split_plan`` is the kernel's plan, a function of static shapes alone:
the tests call it with integers only, as the wrapper does, so no launch
can depend on a device value (the context lengths stay on the device).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import quantized_attention as jqa
from paddle_tpu.ops.pallas.decode_attention import paged_decode_attention

from paddle_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-5
H, D, PAGE, P_MAX, N_PAGES = 4, 16, 4, 10, 48
# contexts: mid-page inside the first range (of 3 pages: 12 tokens), on a
# range boundary (12, 24), idle, the whole table (40: the short last range),
# mid-range
CONTEXTS = [9, 12, 24, 0, 40, 17, 5]


def _inputs(rng, h_kv, int8):
    """q [B, H, D], pools (float32, or int8 codes with float32 scales),
    a block table whose entries past each context are real pages too."""
    b = len(CONTEXTS)
    bt = np.stack([rng.choice(np.arange(1, N_PAGES), P_MAX, replace=False)
                   for _ in range(b)]).astype(np.int32)
    ctx = np.array(CONTEXTS, np.int32)
    q = rng.standard_normal((b, H, D)).astype(np.float32)
    shape = (N_PAGES, PAGE, h_kv, D)
    if int8:
        kc = rng.integers(-127, 128, shape).astype(np.int8)
        vc = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (0.5 + rng.random(N_PAGES)).astype(np.float32)
        vs = (0.5 + rng.random(N_PAGES)).astype(np.float32)
        return q, [kc, vc, ks, vs], bt, ctx
    return q, [rng.standard_normal(shape).astype(np.float32),
               rng.standard_normal(shape).astype(np.float32)], bt, ctx


def _reference(q, pools, bt, ctx, int8):
    scale = 1.0 / float(np.sqrt(D))        # a python float: weakly typed
    args = [jnp.asarray(a) for a in (q, *pools, bt, ctx)]
    if int8:
        return np.asarray(jqa.paged_decode_attention_int8(
            *args, scale=scale, interpret=True))
    return np.asarray(paged_decode_attention(*args, scale=scale,
                                             interpret=True))


def _split(q, pools, bt, ctx, int8, pages_per_split):
    t = [torch.from_numpy(a) for a in (q, *pools, bt, ctx)]
    fn = K.paged_decode_attention_int8_split_plain if int8 else \
        K.paged_decode_attention_split_plain
    return fn(*t, pages_per_split=pages_per_split)


@pytest.mark.parametrize("pages_per_split", [1, 3, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
def test_split_plain_matches_pallas(h_kv, int8, pages_per_split):
    rng = np.random.default_rng(11)
    q, pools, bt, ctx = _inputs(rng, h_kv, int8)
    ref = _reference(q, pools, bt, ctx, int8)
    port = _split(q, pools, bt, ctx, int8, pages_per_split)
    assert port.dtype == torch.float32 and not torch.isnan(port).any()
    live = ctx > 0
    np.testing.assert_allclose(port.numpy()[live], ref[live], atol=ATOL,
                               rtol=RTOL)
    assert float(port[torch.from_numpy(~live)].abs().max()) == 0.0


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_split_plain_matches_the_unsplit_plain(int8):
    """The kernel's own plan for these shapes, against the wrapper's
    plain version (the CPU path), idle slot included."""
    rng = np.random.default_rng(12)
    q, pools, bt, ctx = _inputs(rng, 2, int8)
    t = [torch.from_numpy(a) for a in (q, *pools, bt, ctx)]
    plain = (K.paged_decode_attention_int8 if int8
             else K.paged_decode_attention)(*t)
    split = (K.paged_decode_attention_int8_split_plain if int8
             else K.paged_decode_attention_split_plain)(*t)
    np.testing.assert_allclose(split.numpy(), plain.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_all_empty_partials_merge_to_zero(int8):
    """Every slot idle: every range gives m = NEG_INF, l = 0, and the merge
    writes exactly 0, never NaN (exp(NEG_INF - NEG_INF) is 1, so the
    weights of empty partials must be zeroed by l, not by exp)."""
    rng = np.random.default_rng(13)
    q, pools, bt, _ = _inputs(rng, 2, int8)
    ctx = np.zeros(len(CONTEXTS), np.int32)
    port = _split(q, pools, bt, ctx, int8, 3)
    assert not torch.isnan(port).any()
    assert float(port.abs().max()) == 0.0


def test_split_plan_is_a_function_of_shapes():
    """Plain integers in, (splits, pages per split) out: the serving shapes
    (Llama-2-7B at B = 4: 128 (sequence, KV head) pairs, a table of 256
    pages of 16 tokens) split into ranges of 128 keys, 8 pages; with 8 KV
    heads into ranges of the 64-key floor; the tiny model's table (16
    pages of 4) fits one range (the kernel then writes out with no merge);
    a wide batch takes longer ranges; 64 KV heads of 16 query heads make
    two row groups each."""
    assert K.split_plan(4, 32, 32, 256, 16) == (32, 8)
    assert K.split_plan(4, 32, 8, 256, 16) == (64, 4)
    assert K.split_plan(2, 4, 2, 16, 4) == (1, 16)
    assert K.split_plan(64, 32, 32, 256, 16) == (2, 128)
    assert K.split_plan(4, 1024, 64, 256, 16) == (8, 32)
    assert K.split_plan(4, 32, 32, 0, 16) == (1, 1)
    for b in (1, 4, 33, 256):
        for h, h_kv in ((32, 32), (32, 8), (64, 4), (4, 2)):
            for p_max in (1, 7, 10, 256, 4097):
                for page in (1, 4, 16, 256):
                    splits, pps = K.split_plan(b, h, h_kv, p_max, page)
                    assert 1 <= splits <= 64 and 1 <= pps <= p_max
                    # the ranges cover the table, none of them empty
                    assert (splits - 1) * pps < p_max <= splits * pps
