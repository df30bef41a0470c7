"""The port's int8 KV page quantization against the JAX package's.

``paddle_tpu_torch.quantization.page_quant`` gets the same float32 numpy
inputs as ``paddle_tpu.quantization.page_quant``: ``quant_codes``,
``quantize_pages`` and ``write_rows`` must give bit-equal codes and
scales. ``write_rows`` runs a sequence of dispatches on one pool under the
offset-0 freeze rule: a page opened by a dispatch, an append at offset > 0
that clips against the frozen scale, several rows of one page in one
dispatch (duplicate pids), padding rows onto the trash page 0, and the
float cast path (``scales=None``).

Tolerance: none. Both sides run the same float32 expressions in the same
order (divide, multiply by 127, round half to even, clip), so the results
are compared bit for bit. Where several rows of one dispatch land on the
same (page, offset) of the trash page, which one stays is unspecified on
both sides: page 0's codes are left out of that comparison (its scale is
a scatter-max and is compared).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.quantization import page_quant as jpq

from paddle_tpu_torch.quantization import page_quant as tpq

torch.set_num_threads(1)

N_PAGES, PAGE, H, D = 6, 4, 2, 8


def _rows(rng, n, amp=1.0):
    return (amp * rng.standard_normal((n, H, D))).astype(np.float32)


def test_constants_and_quant_codes_bit_equal():
    assert (tpq.QMAX, tpq.EPS) == (jpq.QMAX, jpq.EPS)
    assert np.float32(tpq.INV_QMAX) == np.float32(1.0 / 127.0)
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((5, 7, 16))).astype(np.float32)
    # a zero scale takes the EPS guard; values on half-code boundaries
    # exercise round-half-to-even
    scale = np.abs(rng.standard_normal((5, 7, 1))).astype(np.float32)
    scale[0, 0] = 0.0
    # with a scale of 127, x / 127 * 127 gives back x exactly
    x[1, 0, :4] = [0.5, 1.5, -2.5, 62.5]
    scale[1, 0] = 127.0
    want = np.asarray(jpq.quant_codes(jnp.asarray(x), jnp.asarray(scale)))
    got = tpq.quant_codes(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1, 0, :4].tolist() == [0.0, 2.0, -2.0, 62.0]   # half to even
    deq_w = np.asarray(jpq.dequant_codes(jnp.asarray(want),
                                         jnp.asarray(scale)))
    deq_t = tpq.dequant_codes(got, torch.from_numpy(scale))
    np.testing.assert_array_equal(deq_t.numpy(), deq_w)


def test_quantize_pages_bit_equal():
    rng = np.random.default_rng(1)
    pages = (2 * rng.standard_normal((2, 3, PAGE, H, D))).astype(np.float32)
    pages[1, 2] = 0.0                       # an empty page: scale EPS
    qw, sw = jpq.quantize_pages(jnp.asarray(pages))
    qt, st = tpq.quantize_pages(torch.from_numpy(pages))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert st.shape == (2, 3)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qw))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sw))
    assert st[1, 2] == np.float32(tpq.EPS)
    assert int(qt.abs().max()) == 127        # each page's absmax maps to 127
    back_w = np.asarray(jpq.dequantize_pages(qw, sw))
    np.testing.assert_array_equal(
        tpq.dequantize_pages(qt, st).numpy(), back_w)


def _dispatch(pid_off, rows):
    pids = np.array([p for p, _ in pid_off], np.int32)
    offs = np.array([o for _, o in pid_off], np.int32)
    return pids, offs, rows


# each case: a list of dispatches ([(pid, offset), ...], row amplitude)
WRITE_CASES = {
    # page 1 opened by a whole-page write, page 2 by two rows
    "open": [([(1, 0), (1, 1), (1, 2), (1, 3), (2, 0), (2, 1)], 1.0)],
    # page 3 opened small, then rows 10x larger appended at offsets 2, 3:
    # they clip against the frozen scale
    "append_clips": [([(3, 0), (3, 1)], 0.1), ([(3, 2)], 10.0),
                     ([(3, 3), (4, 0)], 10.0)],
    # one dispatch lands several rows in page 2, opening it at offset 0
    # and setting its scale from all of them (a chunk of a ragged step)
    "duplicate_pids": [([(2, 0), (2, 1), (2, 2), (5, 0), (2, 3)], 1.0),
                       ([(5, 1), (5, 2)], 3.0)],
    # padding rows all target the trash page 0 at offset 0
    "padding_trash": [([(1, 0), (1, 1), (0, 0), (0, 0), (0, 0)], 1.0),
                      ([(1, 2), (0, 0), (0, 0)], 2.0)],
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_write_rows_freeze_rule_bit_equal(case):
    rng = np.random.default_rng(2)
    pages_j = jnp.zeros((N_PAGES, PAGE, H, D), jnp.int8)
    scales_j = jnp.ones((N_PAGES,), jnp.float32)
    pages_t = torch.zeros((N_PAGES, PAGE, H, D), dtype=torch.int8)
    scales_t = torch.ones(N_PAGES)
    for targets, amp in WRITE_CASES[case]:
        pids, offs, rows = _dispatch(targets, _rows(rng, len(targets), amp))
        before = scales_t.clone()
        pages_j, scales_j = jpq.write_rows(pages_j, scales_j,
                                           jnp.asarray(pids),
                                           jnp.asarray(offs),
                                           jnp.asarray(rows))
        out_p, out_s = tpq.write_rows(pages_t, scales_t,
                                      torch.from_numpy(pids),
                                      torch.from_numpy(offs),
                                      torch.from_numpy(rows))
        assert out_p is pages_t and out_s is scales_t     # in place
        np.testing.assert_array_equal(scales_t.numpy(), np.asarray(scales_j))
        np.testing.assert_array_equal(pages_t.numpy()[1:],
                                      np.asarray(pages_j)[1:])
        opened = {p for p, o in targets if o == 0}
        for p in range(N_PAGES):
            lands = [i for i, (q, _) in enumerate(targets) if q == p]
            if p in opened:        # the dispatch absmax over its rows
                want = max(float(np.abs(rows[i]).max()) for i in lands)
                assert float(scales_t[p]) == np.float32(want)
            else:                  # frozen
                assert float(scales_t[p]) == float(before[p])
    if case == "append_clips":
        assert int(pages_t[3, 2].abs().max()) == 127     # clipped
        assert float(scales_t[3]) < 1.0                  # still the small one


def test_write_rows_float_cast_path():
    """scales=None casts the rows into a float pool, as the JAX module's
    ``pages.at[pids, offs].set(rows.astype(dtype))``."""
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((N_PAGES, PAGE, H, D)).astype(np.float32)
    pids = np.array([[1, 1], [4, 0]], np.int32)       # a [C, Q] layout
    offs = np.array([[2, 3], [0, 1]], np.int32)
    rows = rng.standard_normal((2, 2, H, D)).astype(np.float32)
    want, none = jpq.write_rows(jnp.asarray(pool), None, jnp.asarray(pids),
                                jnp.asarray(offs), jnp.asarray(rows))
    assert none is None
    got = torch.from_numpy(pool.copy()).to(torch.bfloat16)
    out, s = tpq.write_rows(got, None, torch.from_numpy(pids),
                            torch.from_numpy(offs), torch.from_numpy(rows))
    assert s is None and out is got
    np.testing.assert_array_equal(
        got.float().numpy(),
        torch.from_numpy(np.array(want)).to(torch.bfloat16).float().numpy())
