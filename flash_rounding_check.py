"""Where the tensor-core flash kernels' errors come from, on one CUDA card.

    python3 flash_rounding_check.py

chip_smoke.py holds the 16-bit (tensor-core) flash backward to a rule that
lets a small share of the elements past the per-element allowance
2^-7 |want| + 2^-8 rms(want) (chip_smoke._within). This script shows why,
in two parts:

1. accumulation: with q = 0 and no mask, every P is exactly 1 / S_k, so
   out = mean(V) and dV = mean(dO) are exact in float64; the kernels'
   largest errors in bf16 ulps then measure their float32 accumulation
   alone (the float32 SIMT kernels beside them, in float32 ulps of bf16
   too). It fails (exit 1) beyond one ulp;
2. rounding: at [4, 2048, 16, 128] bf16 causal, the kernel's gradients
   and the plain version's (``p_dtype=bf16``) against a float64 version
   that rounds P and dS to bf16 at the same points: the largest err /
   allowance and the share of elements past it. Both sides round float32
   values that differ in their last bits, so a few elements flip;
3. the small shape: at [2, 300, 8 -> 4, 64] bf16 causal (the smoke's
   ``flash_attention_bwd[small]``) over seeds 0-15, the share of
   elements past the allowance for the kernel against the plain version
   (the smoke's comparison, held there to 1e-5, which at 153,600 elements
   a gradient allows one element), and for each of them against the
   float64 version with the same roundings. Printed, not held.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))


def _ulps(got, exact):
    e = exact.double()
    ulp = torch.pow(2.0, torch.floor(torch.log2(e.abs().clamp_min(1e-30))) - 7)
    return float(((got.double() - e).abs() / ulp).max())


def _ref64(q, k, v, out, lse, do, p_dtype):
    """dq, dk, dv of causal attention in float64, P and dS rounded to
    p_dtype before the products as the tensor-core kernels round them
    (GQA: each KV head serves rep consecutive query heads; its dk, dv sum
    over them)."""
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    scale = d ** -0.5
    k, v = (x.repeat_interleave(rep, dim=2) for x in (k, v))
    qd, kd, vd, dod = (x.double().transpose(1, 2) for x in (q, k, v, do))
    p = torch.exp(qd @ kd.transpose(-1, -2) * scale - lse.double()[..., None])
    vis = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(
        s_k - s_q)
    p = p.masked_fill(~vis, 0.0)
    delta = (do.double() * out.double()).sum(-1).transpose(1, 2)
    ds = p * (dod @ vd.transpose(-1, -2) - delta[..., None])
    p, ds = p.to(p_dtype).double(), ds.to(p_dtype).double()
    grads = (ds @ kd * scale, ds.transpose(-1, -2) @ qd * scale,
             p.transpose(-1, -2) @ dod)
    dq, dk, dv = (g.transpose(1, 2) for g in grads)
    return [dq] + [g.reshape(b, s_k, h_kv, rep, d).sum(3) for g in (dk, dv)]


def _past_rule(got, want):
    """(largest err / allowance, share of elements past it)."""
    r = want.double()
    rms = float(r.square().mean().sqrt())
    ratio = (got.double() - r).abs() / (2 ** -7 * r.abs() + 2 ** -8 * rms)
    return float(ratio.max()), float((ratio > 1).double().mean())


def main():
    if not torch.cuda.is_available():
        sys.exit("flash_rounding_check.py needs a CUDA card")
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build_all(("flash_fwd_sm90", "flash_bwd_sm90", "flash_attention",
                      "flash_attention_bwd"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def rnd(shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, torch.bfloat16)

    ok = True
    for s in (256, 2048, 8192):
        b, h, d = 1, 8, 128
        q = torch.zeros(b, s, h, d, device=dev, dtype=torch.bfloat16)
        k, v, do = rnd((b, s, h, d)), rnd((b, s, h, d)), rnd((b, s, h, d))
        exact_out = v.double().mean(1, keepdim=True).expand(b, s, h, d)
        exact_dv = do.double().mean(1, keepdim=True).expand(b, s, h, d)
        out, lse = K.flash_attention_fwd(q, k, v)
        dv = K.flash_attention_bwd(q, k, v, out, lse, do)[2]
        f = [x.float() for x in (q, k, v, do)]
        out32, lse32 = K.flash_attention_fwd(*f[:3])
        dv32 = K.flash_attention_bwd(*f[:3], out32, lse32, f[3])[2]
        e = [_ulps(out, exact_out), _ulps(dv, exact_dv),
             _ulps(out32, exact_out), _ulps(dv32, exact_dv)]
        ok = ok and max(e[:2]) <= 1.0
        print(f"[accumulation] exact P = 1/{s}: tensor-core out "
              f"{e[0]:.2f} ulps, dv {e[1]:.2f}; SIMT float32 out "
              f"{e[2]:.2f}, dv {e[3]:.2f} (bf16 ulps; <= 1 for the "
              f"tensor-core kernels)", flush=True)

    b, s, h, d = 4, 2048, 16, 128
    q, k, v, do = (rnd((b, s, h, d)) for _ in range(4))
    out, lse = K.flash_attention_fwd(q, k, v, causal=True)
    kernel = K.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    plain = K.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                        p_dtype=torch.bfloat16)
    ref = _ref64(q, k, v, out, lse, do, torch.bfloat16)
    for name, grads in (("kernel", kernel), ("plain p_dtype=bf16", plain)):
        cells = [_past_rule(g, r) for g, r in zip(grads, ref)]
        print(f"[rounding] {name} vs float64 with the same roundings at "
              f"[{b}, {s}, {h}, {d}] bf16 causal: dq/dk/dv err/allowance "
              + "/".join(f"{w:.3f}" for w, _ in cells) + ", share past it "
              + "/".join(f"{f:.2e}" for _, f in cells), flush=True)

    b, s, h, h_kv, d = 2, 300, 8, 4, 64
    share = {"kernel vs plain": [], "plain vs float64": [],
             "kernel vs float64": []}
    for seed in range(16):
        g = np.random.default_rng(seed)
        q, do = (torch.from_numpy(g.standard_normal(
            (b, s, h, d), dtype=np.float32)).to(dev, torch.bfloat16)
            for _ in range(2))
        k, v = (torch.from_numpy(g.standard_normal(
            (b, s, h_kv, d), dtype=np.float32)).to(dev, torch.bfloat16)
            for _ in range(2))
        out, lse = K.flash_attention_fwd(q, k, v, causal=True)
        kernel = K.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
        plain = K.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                            causal=True,
                                            p_dtype=torch.bfloat16)
        ref = _ref64(q, k, v, out, lse, do, torch.bfloat16)
        line = []
        for name, got, want in (("kernel vs plain", kernel, plain),
                                ("plain vs float64", plain, ref),
                                ("kernel vs float64", kernel, ref)):
            cells = [_past_rule(x, r) for x, r in zip(got, want)]
            share[name].append(max(f for _, f in cells))
            line.append(f"{name} err/allowance " + "/".join(
                f"{w:.3f}" for w, _ in cells) + " share past it " +
                "/".join(f"{f:.2e}" for _, f in cells))
        print(f"[small] seed {seed} [{b}, {s}, {h} -> {h_kv}, {d}] bf16 "
              f"causal, dq/dk/dv: " + "; ".join(line), flush=True)
    n = b * s * h_kv * d
    for name, f in share.items():
        print(f"[small] {name}: seeds with a share past 1e-5 in dq, dk "
              f"or dv (dk, dv: {n} elements): {sum(x > 1e-5 for x in f)} "
              f"of {len(f)}; largest share {max(f):.2e}", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
