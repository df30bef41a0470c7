"""Versions of the RoPE kernel side by side, on one CUDA card.

    python3 rope_ab.py

Builds csrc/rope.cu as it stands ("tree") and versions derived from it by
one textual change each, in parallel (one nvcc each, the port's flags),
then at the main path's shapes (bfloat16, 7B heads: q and k of a dense
admission, a ragged chunk's per-token rows, a decode step's, and q and k
of the training step) times each version, one launch at a time after an
L2-emptying read and a ~1 ms device spin (chip_smoke._time_ms), beside
two yardsticks: a device copy of the same bytes (``Tensor.copy_``: what
moving q and k costs with no arithmetic) and a one-element kernel (the
timing floor of this method). Every version's output must equal the
tree's bit for bit. The versions:

- float: 16-bit types computed one element at a time in float32 and
  rounded after each operation, as the scalar path does, instead of two
  at a time on packed bf16x2 words;
- unroll2 / unroll8: a lane group loads 2 or 8 heads before its first
  store (the tree: 4).

Prints the card's name and power limit and each version's registers.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

VERSIONS = {
    "tree": [],
    "float": [("  if constexpr (sizeof(T) == 2) {",
               "  if constexpr (false) {")],
    "unroll2": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
}
# (label, B, S, Hq, Hk, per-token rows)
SHAPES = (("qk dense [4,256,32,128]x2", 4, 256, 32, 32, False),
          ("rows chunk [4,256,32,128]x2", 4, 256, 32, 32, True),
          ("rows decode [4,1,32,128]x2", 4, 1, 32, 32, True),
          ("qk train [4,2048,16,128]x2", 4, 2048, 16, 16, False))


def build():
    """{version: ctypes library}, built in parallel; prints registers."""
    from chip_smoke import _ptxas_kernels
    from paddle_tpu_torch.ops.kernels import _build, rope
    src = (_build.CSRC / "rope.cu").read_text()
    out = ROOT / "build" / "rope_ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in VERSIONS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"version {name}: {old!r} not in rope.cu")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        for kernel, used in _ptxas_kernels(log):
            if "rope_vec_kernel<__nv_bfloat16, float" in kernel:
                print(f"[ptxas] {name}: {kernel}: {used}", flush=True)
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.ptt_rope.argtypes, lib.ptt_rope.restype = rope._ARGS, ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("rope_ab.py needs a CUDA card")
    from chip_smoke import _nvidia_smi, _time_ms
    from paddle_tpu_torch.ops.kernels import _build
    print(_nvidia_smi(), flush=True)
    libs = build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    ok = True
    for label, b, s, hq, hk, rows in SHAPES:
        d = 128
        q, k = (torch.from_numpy(rng.standard_normal(
            (b, s, h, d), dtype=np.float32)).to(dev, bf16) for h in (hq, hk))
        shape = ((b, d) if s == 1 else (b, s, d)) if rows else (s, d)
        cos, sin = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev) for _ in range(2))
        outs = {}
        vec = ctypes.c_int(0)

        def call(lib, oq, ok_):
            code = lib.ptt_rope(
                *[_build.ptr(t) for t in (q, k, oq, ok_, cos, sin)], b * s,
                s, hq, hk, d, s if rows else 0, 0, _build.dtype_code(q),
                _build.dtype_code(cos), ctypes.byref(vec), _build.stream(q))
            _build.check(code, "rope_ab")
            if not vec.value:
                raise SystemExit(f"{label}: the scalar path was taken")

        times = {}
        for name, lib in libs.items():
            oq, ok_ = torch.empty_like(q), torch.empty_like(k)
            call(lib, oq, ok_)
            outs[name] = (oq, ok_)
            times[name] = _time_ms(lambda: call(lib, oq, ok_))
        torch.cuda.synchronize()
        same = {n: all(torch.equal(a, b_) for a, b_ in zip(o, outs["tree"]))
                for n, o in outs.items()}
        ok = ok and all(same.values())
        n = q.numel() + k.numel()
        src = torch.empty(n, device=dev, dtype=bf16)
        dst = torch.empty_like(src)
        copy_ms = _time_ms(lambda: dst.copy_(src))
        one = torch.zeros(1, device=dev)
        floor_ms = _time_ms(lambda: one.add_(1))
        nbytes = 4 * n + 2 * cos.numel() * 4
        print(f"[rope_ab] {label}: bound_ms={nbytes / 3.35e12 * 1e3:.4f} "
              f"copy_same_bytes_ms={copy_ms:.4f} one_element_kernel_ms="
              f"{floor_ms:.4f} " + " ".join(
                  f"{nm}={t:.4f}" for nm, t in times.items()) +
              f" bit-equal to tree: {same}", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
