"""n:m structured sparsity (ASP): the counterpart of
``paddle_tpu/incubate/asp.py`` (the mask algorithms ``get_mask_1d``,
``get_mask_2d_greedy``, ``get_mask_2d_best`` and their checks,
``create_mask``, ``check_sparsity``, ``calculate_density``, the excluded
layers, ``prune_model``, ``OptimizerWithSparsityGuarantee`` and
``decorate``).

The mask functions take numpy arrays (or tensors, read to the host) and
return numpy arrays, as the JAX functions do. Two paths stay on the
tensor's device because the host path would move whole weights across:
``prune_model`` with ``mask_1d`` computes its masks with a stable
descending sort of each group's magnitudes (the order numpy's sort gives
groups of 4: ties keep the lower index), and ``check_sparsity`` of a
tensor counts its groups' nonzeros there. The 2-d algorithms run on the
host, as in JAX. Masks are remembered per parameter (dropped with it),
so a decorated optimizer re-applies them after every step.
"""

from __future__ import annotations

import itertools
import weakref
from enum import Enum

import numpy as np
import torch

_MASKS = {}            # id(param) -> mask on the parameter's device
_EXCLUDED = set()      # layer-name fragments excluded from pruning


class MaskAlgo(Enum):
    MASK_1D = "mask_1d"
    MASK_2D_GREEDY = "mask_2d_greedy"
    MASK_2D_BEST = "mask_2d_best"


class CheckMethod(Enum):
    CHECK_1D = "check_1d"
    CHECK_2D = "check_2d"

    @staticmethod
    def get_checking_method(mask_algo):
        if mask_algo in (MaskAlgo.MASK_2D_GREEDY, MaskAlgo.MASK_2D_BEST):
            return CheckMethod.CHECK_2D
        return CheckMethod.CHECK_1D


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _pad_last(arr, m):
    pad = (-arr.shape[-1]) % m
    if pad:
        arr = np.concatenate(
            [arr, np.zeros(arr.shape[:-1] + (pad,), arr.dtype)], axis=-1)
    return arr, pad


def get_mask_1d(mat, n=2, m=4):
    """Keep the n largest-magnitude of every m consecutive weights along
    the last axis (a last axis not divisible by m is padded; the padding
    is always pruned)."""
    arr = _np(mat)
    shape = arr.shape
    arr, pad = _pad_last(arr, m)
    groups = arr.reshape(-1, m)
    idx = np.argsort(-np.abs(groups), axis=1)[:, :n]
    mask = np.zeros_like(groups, dtype=np.float32)
    np.put_along_axis(mask, idx, 1.0, axis=1)
    mask = mask.reshape(arr.shape)
    if pad:
        mask = mask[..., :shape[-1]]
    return mask


def _device_mask_1d(w, n=2, m=4):
    """``get_mask_1d`` of a 2-d tensor on its own device, in its type
    (stable sort: ties keep the lower index)."""
    rows, cols = w.shape
    pad = (-cols) % m
    a = w.detach().abs()
    if pad:
        a = torch.cat([a, a.new_zeros(rows, pad)], dim=1)
    groups = a.reshape(-1, m)
    idx = torch.sort(groups, dim=1, descending=True, stable=True)[1][:, :n]
    mask = torch.zeros_like(groups).scatter_(1, idx, 1.0)
    return mask.reshape(rows, cols + pad)[:, :cols]


def check_mask_1d(mat, n=2, m=4):
    arr, _ = _pad_last(_np(mat), m)
    groups = (arr.reshape(-1, m) != 0).sum(axis=1)
    return bool((groups <= n).all())


def _blocks_2d(arr, m):
    """A 2-d (padded) matrix as m x m blocks: [nb, m, m]."""
    r, c = arr.shape
    return (arr.reshape(r // m, m, c // m, m).transpose(0, 2, 1, 3)
            .reshape(-1, m, m))


def _unblocks_2d(blocks, r, c, m):
    return (blocks.reshape(r // m, c // m, m, m).transpose(0, 2, 1, 3)
            .reshape(r, c))


def _pad_2d(arr, m):
    pr = (-arr.shape[0]) % m
    pc = (-arr.shape[1]) % m
    if pr or pc:
        arr = np.pad(arr, ((0, pr), (0, pc)))
    return arr, pr, pc


def get_mask_2d_greedy(mat, n=2, m=4):
    """Per m x m block, admit entries in descending |w| order while their
    row and column of the block hold fewer than n."""
    orig = _np(mat)
    arr, pr, pc = _pad_2d(orig, m)
    blocks = _blocks_2d(np.abs(arr), m)
    mask_blocks = np.zeros_like(blocks, dtype=np.float32)
    for b in range(blocks.shape[0]):
        order = np.argsort(-blocks[b].ravel())
        rows = np.zeros(m, np.int64)
        cols = np.zeros(m, np.int64)
        for flat in order:
            i, j = divmod(int(flat), m)
            if rows[i] < n and cols[j] < n:
                mask_blocks[b, i, j] = 1.0
                rows[i] += 1
                cols[j] += 1
    mask = _unblocks_2d(mask_blocks, arr.shape[0], arr.shape[1], m)
    return mask[:orig.shape[0], :orig.shape[1]]


_PATTERNS_CACHE = {}


def _compute_valid_2d_patterns(n, m):
    """Every m x m 0/1 matrix with exactly n ones per row and column."""
    key = (n, m)
    if key in _PATTERNS_CACHE:
        return _PATTERNS_CACHE[key]
    row_choices = list(itertools.combinations(range(m), n))
    pats = []
    for rows in itertools.product(row_choices, repeat=m):
        colcnt = np.zeros(m, np.int64)
        for r in rows:
            for j in r:
                colcnt[j] += 1
        if (colcnt == n).all():
            p = np.zeros((m, m), np.float32)
            for i, r in enumerate(rows):
                p[i, list(r)] = 1.0
            pats.append(p)
    pats = np.stack(pats)
    _PATTERNS_CACHE[key] = pats
    return pats


def get_mask_2d_best(mat, n=2, m=4):
    """Per block, the valid n-per-row-and-column pattern that keeps the
    most |w| (exhaustive)."""
    orig = _np(mat)
    arr, pr, pc = _pad_2d(orig, m)
    blocks = _blocks_2d(np.abs(arr), m)                  # [nb, m, m]
    pats = _compute_valid_2d_patterns(n, m)              # [np, m, m]
    scores = np.einsum("bij,pij->bp", blocks, pats)
    best = np.argmax(scores, axis=1)
    mask_blocks = pats[best]
    mask = _unblocks_2d(mask_blocks, arr.shape[0], arr.shape[1], m)
    return mask[:orig.shape[0], :orig.shape[1]]


def check_mask_2d(mat, n=2, m=4):
    arr, _, _ = _pad_2d(_np(mat), m)
    blocks = _blocks_2d((arr != 0).astype(np.int64), m)
    return bool((blocks.sum(axis=1) <= n).all()
                and (blocks.sum(axis=2) <= n).all())


_MASK_FNS = {
    MaskAlgo.MASK_1D: get_mask_1d,
    MaskAlgo.MASK_2D_GREEDY: get_mask_2d_greedy,
    MaskAlgo.MASK_2D_BEST: get_mask_2d_best,
}


def create_mask(tensor, func_name=MaskAlgo.MASK_1D, n=2, m=4):
    """The mask of a rank-1..4 tensor (numpy): rank 3 merges the leading
    two dims, rank 4 (a conv weight) prunes along the input channels."""
    if isinstance(func_name, str):
        func_name = MaskAlgo(func_name)
    fn = _MASK_FNS[func_name]
    arr = _np(tensor)
    shape = arr.shape
    if arr.ndim == 1:
        return get_mask_1d(arr.reshape(1, -1), n, m).reshape(shape)
    if arr.ndim == 2:
        return fn(arr, n, m)
    if arr.ndim == 3:
        return fn(arr.reshape(shape[0] * shape[1], shape[2]),
                  n, m).reshape(shape)
    if arr.ndim == 4:
        t = arr.transpose(0, 1, 3, 2).reshape(
            shape[0] * shape[1] * shape[3], shape[2])
        mask = fn(t, n, m)
        return (mask.reshape(shape[0], shape[1], shape[3], shape[2])
                .transpose(0, 1, 3, 2))
    raise ValueError(f"create_mask supports rank<=4, got {arr.ndim}")


def check_sparsity(tensor, func_name=CheckMethod.CHECK_1D, n=2, m=4):
    """Whether every group (1-d) or block (2-d) keeps at most n nonzeros;
    a tensor's 1-d check runs on its device."""
    if isinstance(func_name, str):
        func_name = CheckMethod(func_name)
    if func_name is CheckMethod.CHECK_1D and isinstance(tensor, torch.Tensor):
        t = tensor.detach()
        t = t.reshape(-1, t.shape[-1]) if t.dim() != 2 else t
        pad = (-t.shape[-1]) % m
        nz = (t != 0)
        if pad:
            nz = torch.cat([nz, nz.new_zeros(nz.shape[0], pad)], dim=1)
        return bool((nz.reshape(-1, m).sum(dim=1) <= n).all())
    arr = _np(tensor)
    mat = arr.reshape(-1, arr.shape[-1]) if arr.ndim != 2 else arr
    if func_name is CheckMethod.CHECK_1D:
        return check_mask_1d(mat, n, m)
    return check_mask_2d(mat, n, m)


def calculate_density(tensor):
    if isinstance(tensor, torch.Tensor):
        return float((tensor.detach() != 0).double().mean())
    return float((np.asarray(tensor) != 0).mean())


def set_excluded_layers(param_names, main_program=None):
    """Layers (name fragments) whose parameters are not pruned."""
    _EXCLUDED.update(param_names)


def reset_excluded_layers(main_program=None):
    _EXCLUDED.clear()


def _prunable(layer):
    from .. import nn
    return isinstance(layer, (nn.Linear, nn.Conv2D))


def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """n:m masks on every Linear / Conv2D weight (mask_algo: mask_1d,
    mask_2d_greedy or mask_2d_best), applied in place and remembered for
    the decorated optimizers."""
    algo = MaskAlgo(mask_algo) if isinstance(mask_algo, str) else mask_algo
    for name, layer in model.named_modules():
        if not _prunable(layer) or getattr(layer, "weight", None) is None:
            continue
        if any(ex in name for ex in _EXCLUDED):
            continue
        w = layer.weight
        if w.dim() < 2:
            continue
        if algo is MaskAlgo.MASK_1D and w.dim() == 2:
            mask = _device_mask_1d(w, n, m).to(w.dtype)
        else:
            mask = torch.as_tensor(create_mask(w, algo, n, m)).to(
                device=w.device, dtype=w.dtype)
        with torch.no_grad():
            w.mul_(mask)
        _MASKS[id(w)] = mask
        weakref.finalize(w, _MASKS.pop, id(w), None)
    return model


class OptimizerWithSparsityGuarantee:
    """Re-applies the prune masks after every step of the wrapped
    optimizer (an update never revives a pruned weight); the rest passes
    through."""

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def step(self):
        self._optimizer.step()
        with torch.no_grad():
            for p in self._optimizer._parameter_list:
                mask = _MASKS.get(id(p))
                if mask is not None:
                    p.mul_(mask)

    def clear_grad(self, *a, **kw):
        return self._optimizer.clear_grad(*a, **kw)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._optimizer.state_dict()

    def set_state_dict(self, state):
        return self._optimizer.set_state_dict(state)

    def get_lr(self):
        return self._optimizer.get_lr()

    def __getattr__(self, name):
        if name == "_optimizer":      # guard half-built instances
            raise AttributeError(name)
        return getattr(self._optimizer, name)


def decorate(optimizer):
    """The sparsity-guaranteeing wrapper of `optimizer`."""
    if isinstance(optimizer, OptimizerWithSparsityGuarantee):
        return optimizer
    return OptimizerWithSparsityGuarantee(optimizer)
