"""The tensor-core ragged kernel's walk against the JAX package's Pallas
ragged kernels.

The port's tensor-core ragged kernel (``csrc/ragged_sm90.cu``) owns a tile
of flat query rows (j = q_idx * rep + r, the Pallas kernel's rows) of one
KV group and walks an online softmax over key tiles that cross page
boundaries, up to the last key the tile's last real query sees.
``ragged_paged_attention_tiled_plain`` and its int8 twin are that walk in
plain PyTorch. Here they get the same numpy inputs as
``ragged_paged_attention(..., interpret=True)`` and
``ragged_paged_attention_int8(..., interpret=True)``: the rows of
``test_torch_kernels.py``'s RAGGED_CASES (a chunk at the tail of a cached
prefix ending mid-page, decode rows, padded and dummy rows, block-table
entries past the context that point at real garbage pages), a case whose
key tiles span pages with contexts ending mid-tile and q_lens that are no
multiple of the query tile, and Q_max = 1; MHA and GQA (rep 1, 2, 4), D 16
and 64, int8 codes in [-127, 127] with random per-page scales; key tiles of
8 and 16 over pages of 4 and query tiles of 8 to 128 flat rows.

Tolerances:
- float32, atol 1e-5 / rtol 1e-5 against the Pallas kernels: the same
  float32 products summed in another order (key tiles of 8 or 16 against
  pages of 4; int8 scores as codes times the K multiplier against
  dequantized K), which moves the last bits of values of order 1;
- 1e-6 against the wrapper's plain version (softmax then one product,
  against the online softmax);
- with ``p_dtype=torch.bfloat16`` (P rounded to bf16 before the P V
  product, where the kernel rounds it) on bf16-representable inputs:
  2e-2 absolute against the Pallas kernel (float32 P), the smoke's
  bfloat16 attention tolerance; 1e-6 against the ``p_dtype`` plain version
  when one key tile holds the whole context (the running max is then the
  final max, so both round the same values); and with smaller key tiles
  2^-8 * max|V| (+1e-6): P is rounded relative to each tile's running max
  rather than the final one, so each term may round to the neighbouring
  bf16 value (2^-8 of itself at most), and the terms' weights sum to 1.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import quantized_attention as jqa
from paddle_tpu.ops.pallas.ragged_attention import ragged_paged_attention

from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import ragged_attention as RA

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-5
H, PAGE, P_MAX, N_PAGES = 4, 4, 6, 32
# rows: (context, q_len, pages listed in the table, dummy)
CASES = {
    # test_torch_kernels.py's RAGGED_CASES
    "mixed": [(13, 8, 5, False), (10, 1, 3, False), (3, 3, 2, False),
              (1, 1, 0, True)],
    "prefill": [(8, 8, 3, False), (16, 8, 5, False), (11, 8, 3, False),
                (9, 8, 4, False)],
    "decode_rows": [(1, 1, 1, False), (17, 1, 5, False), (6, 1, 2, False),
                    (1, 1, 0, True)],
    # contexts ending mid-page inside a key tile of 8 or 16 (21: keys
    # 16-20 of the tile [16, 24)); q_lens 7, 6, 2 against query tiles of
    # 4 and 8 positions
    "spans": [(21, 7, 6, False), (14, 6, 4, False), (5, 2, 2, False),
              (1, 1, 0, True)],
    # one query a row (Q_max = 1)
    "qmax1": [(13, 1, 4, False), (1, 1, 1, False), (6, 1, 2, False),
              (1, 1, 0, True)],
}
# (block_rows, block_k): query tiles of 8 flat rows (positions 8 / rep)
# and the kernel's 128; key tiles of 8 and 16 over pages of 4, and 64
TILES = [(8, 8), (8, 16), (64, 16), (128, 64)]


def _inputs(rng, case, h_kv, d, int8, representable=False):
    rows = CASES[case]
    q_max = 1 if case == "qmax1" else 8
    bt = np.zeros((len(rows), P_MAX), np.int32)  # dummy rows: trash page 0
    for i, (_, _, n, _) in enumerate(rows):
        bt[i, :n] = rng.choice(np.arange(1, N_PAGES), n, replace=False)
    ctx = np.array([r[0] for r in rows], np.int32)
    ql = np.array([r[1] for r in rows], np.int32)
    q = rng.standard_normal((len(rows), q_max, H, d)).astype(np.float32)
    shape = (N_PAGES, PAGE, h_kv, d)
    if int8:
        pools = [rng.integers(-127, 128, shape).astype(np.int8),
                 rng.integers(-127, 128, shape).astype(np.int8),
                 (0.1 + 3 * rng.random(N_PAGES)).astype(np.float32),
                 (0.1 + 3 * rng.random(N_PAGES)).astype(np.float32)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2)]
    if representable:          # values a bf16 tensor holds exactly
        q = _bf16_values(q)
        pools = [_bf16_values(p) if p.dtype == np.float32 and p.ndim == 4
                 else p for p in pools]
    return q, pools, bt, ctx, ql


def _bf16_values(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _pallas(q, pools, bt, ctx, ql, int8):
    scale = 1.0 / float(np.sqrt(q.shape[-1]))    # a python float
    args = [jnp.asarray(a) for a in (q, *pools, bt, ctx, ql)]
    if int8:
        return np.asarray(jqa.ragged_paged_attention_int8(
            *args, scale=scale, interpret=True))
    return np.asarray(ragged_paged_attention(*args, scale=scale,
                                             interpret=True))


def _port(fn_float, fn_int8, q, pools, bt, ctx, ql, int8, **kw):
    t = [torch.from_numpy(a) for a in (q, *pools, bt, ctx, ql)]
    return (fn_int8 if int8 else fn_float)(*t, **kw)


def _tiled(*args, **kw):
    return _port(K.ragged_paged_attention_tiled_plain,
                 K.ragged_paged_attention_int8_tiled_plain, *args, **kw)


def _plain(*args, **kw):
    return _port(K.ragged_paged_attention_plain,
                 K.ragged_paged_attention_int8_plain, *args, **kw)


def _assert_padded_zero(out, rows):
    for i, (_, n, _, _) in enumerate(rows):
        if n < out.shape[1]:
            assert float(out[i, n:].abs().max()) == 0.0


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("h_kv", [4, 2, 1], ids=["rep1", "rep2", "rep4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_plain_matches_pallas(case, h_kv, int8):
    rng = np.random.default_rng(21)
    args = _inputs(rng, case, h_kv, 16, int8)
    ref = _pallas(*args, int8)
    for block_rows, block_k in TILES:
        port = _tiled(*args, int8, block_rows=block_rows, block_k=block_k)
        assert port.dtype == torch.float32
        np.testing.assert_allclose(port.numpy(), ref, atol=ATOL, rtol=RTOL,
                                   err_msg=f"tiles {block_rows}/{block_k}")
        _assert_padded_zero(port, CASES[case])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", ["mixed", "spans"])
def test_tiled_plain_matches_pallas_d64(case, int8):
    rng = np.random.default_rng(22)
    args = _inputs(rng, case, 2, 64, int8)
    ref = _pallas(*args, int8)
    for block_rows, block_k in TILES:
        port = _tiled(*args, int8, block_rows=block_rows, block_k=block_k)
        np.testing.assert_allclose(port.numpy(), ref, atol=ATOL, rtol=RTOL,
                                   err_msg=f"tiles {block_rows}/{block_k}")


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_plain_matches_the_plain_version(case, int8):
    """p_dtype None: the walk equals the wrapper's plain version (the CPU
    path) within 1e-6, and both zero the padded query rows."""
    rng = np.random.default_rng(23)
    args = _inputs(rng, case, 2, 16, int8)
    plain = _plain(*args, int8)
    for block_rows, block_k in TILES:
        tiled = _tiled(*args, int8, block_rows=block_rows, block_k=block_k)
        np.testing.assert_allclose(tiled.numpy(), plain.numpy(), atol=1e-6,
                                   rtol=0)
    _assert_padded_zero(plain, CASES[case])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", ["mixed", "spans", "prefill"])
def test_p_dtype_rounding(case, int8):
    """P rounded to bf16 where the tensor-core kernel rounds it (int8: P
    times the key's V multiplier) against the Pallas kernel, which keeps P
    float32, and against the p_dtype plain version (module docstring)."""
    rng = np.random.default_rng(24)
    args = _inputs(rng, case, 2, 16, int8, representable=True)
    ref = _pallas(*args, int8)
    bf16 = torch.bfloat16
    plain = _plain(*args, int8, p_dtype=bf16)
    whole = _tiled(*args, int8, block_rows=8, block_k=PAGE * P_MAX,
                   p_dtype=bf16)
    np.testing.assert_allclose(whole.numpy(), plain.numpy(), atol=1e-6,
                               rtol=0)
    if int8:   # the V values: codes times the page multipliers
        v_max = float(np.abs(args[1][1]).max() * args[1][3].max() / 127)
    else:
        v_max = float(np.abs(args[1][1]).max())
    for block_rows, block_k in TILES:
        port = _tiled(*args, int8, block_rows=block_rows, block_k=block_k,
                      p_dtype=bf16)
        assert float(np.abs(port.numpy() - ref).max()) <= 2e-2
        assert float((port - plain).abs().max()) <= 2 ** -8 * v_max + 1e-6
        _assert_padded_zero(port, CASES[case])
    # the rounding is real: it moves the output off the float32-P result
    assert float((plain - _plain(*args, int8)).abs().max()) > 0.0


def _q(dtype, d):
    return torch.zeros(1, 2, 4, d, dtype=dtype)


ROUTES = [
    (torch.bfloat16, 128, 16, "sm90"), (torch.bfloat16, 64, 16, "sm90"),
    (torch.float16, 128, 16, "sm90"), (torch.bfloat16, 128, 8, "sm90"),
    (torch.bfloat16, 128, 128, "sm90"), (torch.bfloat16, 128, 24, "sm90"),
    (torch.float32, 128, 16, "simt"), (torch.bfloat16, 16, 16, "simt"),
    (torch.bfloat16, 96, 16, "simt"), (torch.bfloat16, 128, 4, "simt"),
    (torch.float16, 64, 12, "simt"), (torch.float32, 16, 4, "simt"),
]


@pytest.mark.parametrize(
    "dtype,d,page,rt", ROUTES,
    ids=[f"{str(t)[6:]}-d{d}-page{p}" for t, d, p, _ in ROUTES])
def test_route_by_type_head_dim_and_page(dtype, d, page, rt):
    """bf16/f16 with D 64 or 128 and pages of a multiple of 8 take the
    tensor-core kernel, everything else the SIMT kernel; both entries are
    in sources that build_all builds."""
    assert RA.route(_q(dtype, d), page) == rt
    src, symbols = {
        "sm90": ("ragged_sm90", ("ptt_ragged_attention_sm90",
                                 "ptt_ragged_attention_int8_sm90")),
        "simt": ("ragged_attention", ("ptt_ragged_attention",)),
    }[rt]
    from paddle_tpu_torch.ops.kernels import _build
    assert src in _build.SOURCES
    text = (_build.CSRC / f"{src}.cu").read_text()
    assert all(f"int {s}(" in text for s in symbols)


def test_ragged_launch_counts_by_route():
    """Both ragged wrappers report launches per route; a CPU call takes
    the plain version and counts nothing."""
    counts = K.launch_counts()
    for name in ("ragged_paged_attention", "ragged_paged_attention_int8"):
        assert name in K.ROUTED
        assert {f"{name}.sm90", f"{name}.simt"} <= set(counts)
    K.reset_launch_counts()
    rng = np.random.default_rng(25)
    for int8 in (False, True):
        q, pools, bt, ctx, ql = _inputs(rng, "mixed", 2, 64, int8)
        t = [torch.from_numpy(a) for a in (q, *pools, bt, ctx, ql)]
        t[0] = t[0].to(torch.bfloat16)
        if not int8:
            t[1], t[2] = t[1].to(torch.bfloat16), t[2].to(torch.bfloat16)
        fn = (K.ragged_paged_attention_int8 if int8
              else K.ragged_paged_attention)
        out = fn(*t)
        assert out.dtype == torch.bfloat16 and out.shape == t[0].shape
    assert K.launch_counts() == dict.fromkeys(counts, 0)
