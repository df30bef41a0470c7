"""The long tail of the op surface: the counterpart of
``paddle_tpu/ops/impl/extra.py``.

``check_finite_and_unscale_`` and ``update_loss_scaling_`` are the loss
scaler's two steps at op level, in place on a list of gradients (the
JAX package registers them with wrap=False: they are not counted). The
samplers draw from the port's generators (``binomial``: ``torch.binomial``;
``standard_gamma`` and ``dirichlet``: torch's samplers seeded from the
port's generator; ``truncated_gaussian_random``: the inverse normal CDF
of a uniform draw). ``edit_distance`` and ``gather_tree`` run their
recurrences on the tensors' device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...framework import dtype as dtypes
from ...framework.random import default_generator, next_seed
from ..registry import register_op
from ._common import both, device_of, inexact, shape_of


# ---- elementwise and binary ----------------------------------------------

@register_op("copysign", inplace=True)
def copysign(x, y, name=None):
    x, y = both(x, y)
    x, y = inexact(x), inexact(y)
    rt = torch.result_type(x, y)
    return torch.copysign(x.to(rt), y.to(rt))


@register_op("nextafter")
def nextafter(x, y, name=None):
    x, y = both(x, y)
    rt = torch.result_type(x, y)
    return torch.nextafter(x.to(rt), y.to(rt))


@register_op("gammaincc")
def gammaincc(x, y, name=None):
    """The regularized upper incomplete gamma Q(x, y)."""
    x, y = both(x, y)
    x, y = inexact(x), inexact(y)
    rt = torch.result_type(x, y)
    return torch.special.gammaincc(x.to(rt), y.to(rt))


@register_op("sinc")
def sinc(x, name=None):
    return torch.sinc(inexact(x))


@register_op("ldexp")
def ldexp(x, y, name=None):
    x = inexact(x)
    return x * torch.pow(torch.tensor(2.0, dtype=x.dtype, device=x.device),
                         y.to(torch.int32).to(x.dtype))


@register_op("hypot")
def hypot(x, y, name=None):
    x, y = both(x, y)
    x, y = inexact(x), inexact(y)
    rt = torch.result_type(x, y)
    return torch.hypot(x.to(rt), y.to(rt))


# ---- norms and clipping --------------------------------------------------

@register_op("p_norm")
def p_norm(x, porder=2.0, axis=None, epsilon=1e-12, keepdim=False,
           asvector=False, name=None):
    """The p-norm along `axis` (of everything with asvector or no axis),
    in float32, in x's type."""
    if asvector or axis is None:
        x, axis = x.reshape(-1), 0
    if porder == float("inf"):
        return torch.amax(x.abs(), axis, keepdim=keepdim)
    if porder == float("-inf"):
        return torch.amin(x.abs(), axis, keepdim=keepdim)
    if porder == 0:
        return torch.sum((x != 0).to(x.dtype), axis, keepdim=keepdim)
    ax = x.abs().float()
    out = torch.pow(torch.sum(torch.pow(ax, porder), axis, keepdim=keepdim),
                    1.0 / porder)
    return out.to(x.dtype)


@register_op("frobenius_norm")
def frobenius_norm(x, axis=None, keepdim=False, name=None):
    if axis is None:
        axis = tuple(range(x.dim()))
    elif isinstance(axis, int):
        axis = (axis,)
    return torch.sqrt(torch.sum(torch.square(x), tuple(axis),
                                keepdim=keepdim))


@register_op("squared_l2_norm")
def squared_l2_norm(x, name=None):
    return torch.sum(torch.square(x)).reshape(1)


@register_op("clip_by_norm")
def clip_by_norm(x, max_norm, name=None):
    """x scaled so that its 2-norm is at most max_norm (float32
    inside)."""
    xf = x.float()
    nrm = torch.sqrt(torch.sum(torch.square(xf)))
    scale = torch.where(nrm > max_norm,
                        max_norm / torch.clamp(nrm, min=1e-12),
                        torch.ones_like(nrm))
    return (xf * scale).to(x.dtype)


@register_op("renorm")
def renorm(x, p, axis, max_norm, name=None):
    """Each slice along `axis` scaled so that its p-norm is at most
    max_norm (float32 inside)."""
    dims = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    xf = x.float()
    norms = torch.pow(torch.sum(torch.pow(xf.abs(), p), dims, keepdim=True),
                      1.0 / p)
    scale = torch.where(norms > max_norm,
                        max_norm / torch.clamp(norms, min=1e-12),
                        torch.ones_like(norms))
    return (xf * scale).to(x.dtype)


# ---- the loss scaler's steps ---------------------------------------------

@register_op("check_finite_and_unscale_", amp=False, wrap=False)
def check_finite_and_unscale_(xs, scale, found_inf=None, name=None):
    """Each gradient of `xs` times 1 / scale in float32, written back in
    its own type (in place); returns (xs, found_inf [1] bool): whether
    any is not finite."""
    scale = scale if isinstance(scale, torch.Tensor) else \
        torch.tensor(float(scale))
    flags = []
    with torch.no_grad():
        for t in xs:
            v = t.float() / scale.to(t.device, torch.float32)
            flags.append(~torch.isfinite(v).all())
            t.copy_(v.to(t.dtype))
    found = torch.stack(flags).any().reshape(1) if flags else \
        torch.zeros(1, dtype=torch.bool)
    return xs, found


@register_op("update_loss_scaling_", amp=False, wrap=False)
def update_loss_scaling_(xs, found_inf, prev_loss_scaling, in_good_steps,
                         in_bad_steps, incr_every_n_steps,
                         decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                         stop_update=False, name=None):
    """The dynamic loss scale's state machine (``GradScaler.update``):
    returns (xs, scale, good steps, bad steps); on found_inf the
    gradients of `xs` are zeroed in place."""
    def val(t):
        return t if isinstance(t, torch.Tensor) else torch.tensor(t)

    found = val(found_inf).reshape(()).bool()
    prev = val(prev_loss_scaling)
    scale = prev.float()
    good = val(in_good_steps).to(torch.int32)
    bad = val(in_bad_steps).to(torch.int32)
    zero = torch.zeros_like(bad)
    new_bad = torch.where(found, bad + 1, zero)
    new_good = torch.where(found, zero, good + 1)
    dec = new_bad >= decr_every_n_nan_or_inf
    inc = new_good >= incr_every_n_steps
    new_scale = torch.where(
        dec, torch.clamp(scale * decr_ratio, min=1.0),
        torch.where(inc, scale * incr_ratio, scale))
    new_bad = torch.where(dec, zero, new_bad)
    new_good = torch.where(inc, zero, new_good)
    with torch.no_grad():
        for t in xs:
            t.copy_(torch.where(found.to(t.device), torch.zeros_like(t), t))
    return (xs, new_scale.reshape(prev.shape if prev.dim() else (1,)),
            new_good.reshape(-1), new_bad.reshape(-1))


# ---- creation and filling ------------------------------------------------

@register_op("fill", inplace=True)
def fill(x, value, name=None):
    return torch.full_like(x, value)


@register_op("fill_diagonal", inplace=True)
def fill_diagonal(x, value=0.0, offset=0, wrap=False, name=None):
    """The diagonal of x set to value (of every dim's common index when x
    is not 2-D); wrap continues down a tall matrix, one row below each
    full pass, on the flat buffer at stride m + 1."""
    out = x.clone()
    if x.dim() != 2:
        idx = torch.arange(min(x.shape), device=x.device)
        out[(idx,) * x.dim()] = value
        return out
    n, m = x.shape
    if wrap:
        start = offset if offset >= 0 else (-offset) * m
        flat = out.reshape(-1)
        flat[torch.arange(start, n * m, m + 1, device=x.device)] = value
        return flat.reshape(n, m)
    k = min(n - max(-offset, 0), m - max(offset, 0))
    if k <= 0:
        return out
    idx = torch.arange(k, device=x.device)
    out[idx + max(-offset, 0), idx + max(offset, 0)] = value
    return out


@register_op("fill_diagonal_tensor", inplace=True)
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """`y` written onto the diagonal plane of dims (dim1, dim2)."""
    xm = torch.movedim(x, (dim1, dim2), (-2, -1)).clone()
    n, m = xm.shape[-2], xm.shape[-1]
    k = min(n, m - offset) if offset >= 0 else min(n + offset, m)
    idx = torch.arange(k, device=x.device)
    xm[..., idx - min(offset, 0), idx + max(offset, 0)] = y.to(x.dtype)
    return torch.movedim(xm, (-2, -1), (dim1, dim2))


@register_op("shard_index")
def shard_index(x, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    size = (index_num + nshards - 1) // nshards
    return torch.where(x // size == shard_id, x % size,
                       torch.full_like(x, ignore_value))


@register_op("sequence_mask")
def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    if maxlen is None:
        maxlen = int(x.max())
    steps = torch.arange(int(maxlen), device=x.device)
    return (steps < x[..., None]).to(dtypes.convert_dtype(dtype))


# ---- samplers ------------------------------------------------------------

@register_op("binomial")
def binomial(count, prob, name=None):
    """Binomial(count, prob) draws, int64."""
    count, prob = torch.broadcast_tensors(count.float(), prob.float())
    return torch.binomial(count, prob,
                          generator=default_generator(count.device)).to(
        torch.int64)


def _seeded(dev, draw):
    """``draw()`` with torch's global generator of `dev` seeded from the
    port's generator there, and its state restored after (torch's gamma
    and Dirichlet samplers take no generator)."""
    seed = next_seed(default_generator(dev))
    devices = [dev] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        if dev.type == "cuda":
            torch.cuda.manual_seed(seed)
        else:
            torch.manual_seed(seed)
        return draw()


@register_op("standard_gamma")
def standard_gamma(x, name=None):
    """Gamma(x, 1) draws."""
    x = inexact(x)
    return _seeded(x.device, lambda: torch._standard_gamma(x))


@register_op("dirichlet")
def dirichlet(alpha, name=None):
    alpha = inexact(alpha)
    return _seeded(alpha.device, lambda: torch._sample_dirichlet(alpha))


@register_op("truncated_gaussian_random")
def truncated_gaussian_random(shape, mean=0.0, std=1.0, a=-2.0, b=2.0,
                              dtype="float32", name=None, *, device=None):
    """Normal draws restricted to [a, b] (in standard units), times std
    plus mean."""
    dev = device_of(device)
    d = dtypes.convert_dtype(dtype)

    def cdf(v):
        return 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))

    lo, hi = cdf(a), cdf(b)
    u = torch.rand(shape_of(shape), generator=default_generator(dev),
                   dtype=torch.float64, device=dev)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    return (torch.clamp(z, a, b) * std + mean).to(d)


# ---- views ---------------------------------------------------------------

@register_op("as_strided")
def as_strided(x, shape, stride, offset=0, name=None):
    """The strided window of x's row-major buffer (a copy, as the JAX
    op gives)."""
    return torch.as_strided(x.contiguous().reshape(-1), shape_of(shape),
                            shape_of(stride), int(offset)).clone()


@register_op("tensor_unfold")
def tensor_unfold(x, axis, size, step, name=None):
    """Sliding windows along `axis`: [..., n_windows, ..., size]."""
    return x.unfold(axis, size, step)


@register_op("view_dtype")
def view_dtype(x, dtype, name=None):
    return x.view(dtypes.convert_dtype(dtype))


@register_op("reverse")
def reverse(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(x, tuple(axis))


@register_op("mean_all")
def mean_all(x, name=None):
    return torch.mean(inexact(x))


# ---- decode and search helpers -------------------------------------------

@register_op("gather_tree")
def gather_tree(ids, parents, name=None):
    """Beam search's backtrace: ids/parents [max_time, batch, beam]."""
    t_max = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).contiguous()
    outs = [None] * t_max
    for t in range(t_max - 1, -1, -1):
        outs[t] = torch.gather(ids[t], -1, beams)
        beams = torch.gather(parents[t], -1, beams)
    return torch.stack(outs)


@register_op("top_p_sampling")
def top_p_sampling(x, ps, threshold=None, topp_seed=None, seed=-1, k=0,
                   mode="truncated", name=None):
    """Nucleus sampling over probabilities x [B, V] with cut-offs ps [B]:
    returns (scores, ids) [B, 1]. seed >= 0 draws from a generator seeded
    with it."""
    if seed is not None and seed >= 0:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    else:
        gen = default_generator(x.device)
    sorted_p, sorted_idx = torch.sort(x, dim=-1, descending=True,
                                      stable=True)
    cum = torch.cumsum(sorted_p, -1)
    keep = cum - sorted_p < ps.reshape(-1, 1).to(x.dtype)
    filtered = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
    filtered = filtered / filtered.sum(-1, keepdim=True).clamp_min(1e-12)
    choice = torch.multinomial(filtered, 1, generator=gen)
    ids = torch.gather(sorted_idx, -1, choice)
    return torch.gather(x, -1, ids), ids


@register_op("edit_distance")
def edit_distance(hyps, refs, hypslength=None, refslength=None,
                  normalized=True, name=None):
    """Levenshtein distance of each (hyp, ref) pair of the padded [B, T]
    batches: ([B, 1] float32 distances, normalized by the ref length
    when asked, and the batch size [1] int32)."""
    b, th = hyps.shape
    tr = refs.shape[1]
    dev = hyps.device
    hl = torch.full((b,), th, device=dev) if hypslength is None else \
        hypslength.reshape(-1).to(dev)
    rl = torch.full((b,), tr, device=dev) if refslength is None else \
        refslength.reshape(-1).to(dev)
    prev = torch.arange(tr + 1, device=dev).expand(b, tr + 1).clone()
    for i in range(th):
        row = [torch.full((b,), i + 1, device=dev, dtype=prev.dtype)]
        for j in range(tr):
            sub = prev[:, j] + (refs[:, j] != hyps[:, i]).to(prev.dtype)
            row.append(torch.minimum(torch.minimum(prev[:, j + 1] + 1,
                                                   row[-1] + 1), sub))
        new = torch.stack(row, 1)
        prev = torch.where((i < hl)[:, None], new, prev)
    dist = torch.gather(prev, 1, rl.long()[:, None])[:, 0].float()
    if normalized:
        dist = dist / rl.float().clamp_min(1.0)
    return dist.reshape(b, 1), torch.tensor([b], dtype=torch.int32,
                                            device=dev)


@register_op("l1_norm")
def l1_norm(x, name=None):
    return torch.sum(x.abs())


@register_op("identity_loss")
def identity_loss(x, reduction="none", name=None):
    if reduction in (0, "sum"):
        return torch.sum(x)
    if reduction in (1, "mean"):
        return torch.mean(x)
    return x


@register_op("set_value_with_tensor")
def set_value_with_tensor(x, values, starts, ends, steps, axes,
                          decrease_axes=(), none_axes=(), name=None):
    out = x.clone()
    idx = [slice(None)] * x.dim()
    for ax, s, e, st in zip(axes, starts, ends, steps):
        idx[ax] = slice(int(s), int(e), int(st))
    out[tuple(idx)] = values.to(x.dtype) if isinstance(
        values, torch.Tensor) else values
    return out


@register_op("uniform_random_batch_size_like")
def uniform_random_batch_size_like(x, shape, min=-1.0, max=1.0,  # noqa: A002
                                   input_dim_idx=0, output_dim_idx=0,
                                   dtype="float32", name=None):
    shape = list(shape)
    shape[output_dim_idx] = x.shape[input_dim_idx]
    u = torch.rand(shape, generator=default_generator(x.device),
                   dtype=dtypes.convert_dtype(dtype), device=x.device)
    return u * (max - min) + min


@register_op("conv2d_transpose_bias")
def conv2d_transpose_bias(x, filter, bias, strides=(1, 1),  # noqa: A002
                          paddings=(0, 0), output_padding=(),
                          padding_algorithm="EXPLICIT", groups=1,
                          dilations=(1, 1), data_format="NCHW", name=None):
    """A transposed 2-D convolution (weight [C_in, C_out / groups, kH,
    kW]) plus bias, NCHW or NHWC; output_padding is ignored, as in the
    JAX op."""
    nhwc = not data_format.startswith("NC")
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    out = F.conv_transpose2d(x, filter, None, tuple(strides),
                             tuple(paddings), 0, groups, tuple(dilations))
    out = out + bias.reshape(1, -1, 1, 1)
    return out.permute(0, 2, 3, 1) if nhwc else out
