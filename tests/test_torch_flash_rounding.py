"""Where the flash plain versions round, and which kernel a launch takes.

The tensor-core flash kernels round P (forward; backward, before dV) and
dS (before dQ and dK) to the input type, as the TPU kernels do
(``tiles.online_softmax_update(p_dtype=v.dtype)``, ``flash_attention.py``
``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``). Their plain versions take
``p_dtype`` to round at the same points. Here, on bfloat16 inputs, the
plain versions with ``p_dtype=torch.bfloat16`` are held against the
Pallas kernels in interpret mode (forward: ``_flash_fwd_bhsd`` with one
key block, so that the online softmax rounds P against the row's final
max, as the plain version does; backward: ``jax.vjp`` through
``flash_attention_fwd(interpret=True)``), unmasked and with two masked
intervals (``flashmask_attention_fwd``). Both sides round the same float32
values to bf16 at the same points, so they agree to one bf16 ulp per
element (the two float32 sums may straddle a rounding midpoint), and the
rounding version is held closer to the Pallas kernel, in mean absolute
error, than the float32 plain version by at least 2x.

The routing by type and head dim is checked on the C symbol a launch
would take, without launching.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.nn.functional.attention import _flashmask_intervals
from paddle_tpu.ops.pallas.flash_attention import (_flash_fwd_bhsd,
                                                   flash_attention_fwd,
                                                   flashmask_attention_fwd)

from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as FA

torch.set_num_threads(1)

B, S, H, D = 1, 48, 2, 16
BF16 = torch.bfloat16


def _bf16(rng, shape):
    """Seeded values exactly representable in bf16, as float32 numpy."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(BF16).float().numpy()


def _bhsd(x):
    b, s, h, d = x.shape
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                       .reshape(b * h, s, d), jnp.bfloat16)


def _t(x):
    return torch.from_numpy(x).to(BF16)


def _ulps(got, want):
    """Largest |got - want| in bf16 ulps of want, and the mean |got -
    want|."""
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    diff = np.abs(got - want)
    return float((diff / ulp).max()), float(diff.mean())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_forward_rounds_p_where_the_pallas_kernel_does(causal):
    rng = np.random.default_rng(11)
    q, k, v = (_bf16(rng, (B, S, H, D)) for _ in range(3))
    scale = 1.0 / float(np.sqrt(D))
    ref, _ = _flash_fwd_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale, H,
                             H, block_q=16, block_k=S, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32)).reshape(B, H, S, D).transpose(
        0, 2, 1, 3)
    rounded, _ = K.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal,
                                             p_dtype=BF16)
    plain, _ = K.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal)
    worst, err = _ulps(rounded, ref)
    _, err32 = _ulps(plain, ref)
    assert worst <= 1.0
    assert err < 0.5 * err32, (err, err32)


def _vjp_cases():
    return [("mha", None), ("two_intervals", 2)]


@pytest.mark.parametrize("case,nb", _vjp_cases(),
                         ids=[c for c, _ in _vjp_cases()])
def test_backward_rounds_p_and_ds_where_the_pallas_kernels_do(case, nb):
    rng = np.random.default_rng(12)
    q, k, v, w = (_bf16(rng, (B, S, H, D)) for _ in range(4))
    causal = True
    bounds_np = None
    if nb is not None:
        col = np.arange(S)
        start = np.minimum(S, col + rng.integers(1, 9, (B, H, S)))
        end = np.minimum(S, start + rng.integers(0, 17, (B, H, S)))
        idx = np.stack([start, end], -1).astype(np.int32)
        bounds_np = [None if x is None else np.array(x)
                     for x in _flashmask_intervals(jnp.asarray(idx), causal,
                                                   S)]

    def f(q_, k_, v_):
        if bounds_np is None:
            return flash_attention_fwd(q_, k_, v_, causal=causal,
                                       interpret=True, block_q=16,
                                       block_k=S)
        return flashmask_attention_fwd(
            q_, k_, v_, *[None if x is None else jnp.asarray(x)
                          for x in bounds_np], causal=causal,
            interpret=True, block_q=16, block_k=S)

    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    _, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp(jnp.asarray(w, jnp.bfloat16))

    bounds = None if bounds_np is None else tuple(
        None if x is None else torch.from_numpy(x) for x in bounds_np)
    tq, tk, tv, tw = map(_t, (q, k, v, w))
    out, lse = K.flash_attention_fwd_plain(tq, tk, tv, causal, None, bounds,
                                           p_dtype=BF16)
    rounded = K.flash_attention_bwd_plain(tq, tk, tv, out, lse, tw, causal,
                                          None, bounds, p_dtype=BF16)
    plain = K.flash_attention_bwd_plain(tq, tk, tv, out, lse, tw, causal,
                                        None, bounds)
    for name, g, g32, r in zip("qkv", rounded, plain, want):
        assert g.dtype == BF16
        worst, err = _ulps(g, r)
        _, err32 = _ulps(g32, r)
        assert worst <= 1.0, (name, worst)
        assert err < 0.5 * err32, (name, err, err32)


def _t16(dtype, d):
    return torch.zeros(1, 4, 2, d, dtype=dtype)


ROUTES = [
    (BF16, 128, "sm90"), (BF16, 64, "sm90"), (torch.float16, 128, "sm90"),
    (torch.float32, 128, "simt"), (BF16, 16, "simt"), (BF16, 96, "simt"),
]


@pytest.mark.parametrize("dtype,d,rt", ROUTES,
                         ids=[f"{str(t)[6:]}-d{d}" for t, d, _ in ROUTES])
def test_route_by_type_and_head_dim(dtype, d, rt):
    """bf16/f16 with D 64 or 128 take the tensor-core entries, everything
    else the SIMT entries; both sources are built by build_all."""
    q = _t16(dtype, d)
    assert FA.route(q) == rt
    want = {
        "sm90": {("fwd", False): "ptt_flash_attention_fwd_sm90",
                 ("fwd", True): "ptt_flashmask_attention_fwd_sm90",
                 ("bwd", False): "ptt_flash_attention_bwd_sm90",
                 ("bwd", True): "ptt_flashmask_attention_bwd_sm90"},
        "simt": {("fwd", False): "ptt_flash_attention_fwd",
                 ("fwd", True): "ptt_flashmask_attention_fwd",
                 ("bwd", False): "ptt_flash_attention_bwd",
                 ("bwd", True): "ptt_flashmask_attention_bwd"},
    }[rt]
    for (direction, masked), symbol in want.items():
        src, sym = FA.entry(direction, masked, q)
        assert sym == symbol
        assert src in _build.SOURCES
        assert (_build.CSRC / f"{src}.cu").exists()
        assert symbol in (_build.CSRC / f"{src}.cu").read_text()


def test_launch_counts_report_each_route():
    counts = K.launch_counts()
    assert set(counts) == set(K.KERNELS) | {
        f"{n}.{rt}" for n in K.ROUTED for rt in K.ROUTES} | set(K.PARTS)
    K.reset_launch_counts()
    rng = np.random.default_rng(13)
    q = _t(_bf16(rng, (1, 8, 2, 64)))
    K.flash_attention_fwd(q, q, q, causal=True)      # the CPU: plain
    assert K.launch_counts() == dict.fromkeys(counts, 0)
