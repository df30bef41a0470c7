"""A/B timing of versions of the flash forward kernel on one CUDA card.

    python3 flash_fwd_ab.py NAME=SRC.cu [NAME=SRC.cu ...] [--sass DIR]
                            [--tol X]

Each SRC is a version of the flash forward: paddle_tpu_torch/csrc/
flash_attention.cu (C entries ptt_flash_attention_fwd and
ptt_flashmask_attention_fwd) or flash_fwd_sm90.cu (the same entries with
an _sm90 suffix), for example the parent commit's, written out first with

    git show HEAD~1:paddle_tpu_torch/csrc/flash_attention.cu >build/ab/p.cu

Every version is compiled with the port's nvcc flags (one nvcc each, all
started together) into build/ab/ and loaded by ctypes. The script prints
the registers of each version's bfloat16 D = 128 kernels, then times, in
one process on the same inputs, in the order A B ... B A:

- nm0: the unmasked causal forward (ptt_flash_attention_fwd);
- nm1-none: where the version has ptt_flashmask_attention_fwd, the
  one-interval masked forward with bounds that hide nothing
  (start = end = S);
- nm1-doc: the same with chip_smoke's packed-document mask.

The outputs must be bit-equal across versions (nm1-none also to nm0);
the script exits 1 otherwise. Versions whose arithmetic differs (the SIMT
kernel keeps P in float32, the tensor-core kernel rounds it to bf16) are
held instead, with --tol X, to a largest absolute difference of X from the
first version's outputs. Times are chip_smoke._time_ms: one launch at a
time, each after L2 is emptied. With --sass DIR the SASS of the bfloat16
D = 128 kernels goes to DIR, one file per kernel, and the script prints
each kernel's count of instructions, shared loads, FFMAs, branches,
tensor-core products (HGMMA) and TMA loads (UTMALDG).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SHAPES = ((4, 2048, 16, 128), (4, 256, 32, 128))   # training, admission
KERNEL = re.compile(r"(flash(?:mask)?_fwd(?:_sm90)?_kernel)I13__nv_bfloat16"
                    r"Li(8|128)E(?:Li(\d)E)?")


def _build(versions):
    from paddle_tpu_torch.ops.kernels import _build as b
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = b._nvcc()
    procs = {}
    for name, src in versions.items():
        procs[name] = subprocess.Popen(
            [nvcc, *b.NVCC_FLAGS, "-I", str(b.CSRC), "-o",
             str(out_dir / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = out_dir / f"lib{name}.so"
    return libs


def _kernel_label(fn_name):
    m = KERNEL.search(fn_name)
    if m is None:
        return None
    return f"{m.group(1)}<bf16,{m.group(2)},{m.group(3) or 0}>"


def _registers(lib):
    out = subprocess.run(["cuobjdump", "--dump-resource-usage", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    regs = {}
    lines = out.splitlines()
    for i, line in enumerate(lines):
        label = _kernel_label(line)
        if label and i + 1 < len(lines):
            m = re.search(r"REG:(\d+)", lines[i + 1])
            if m:
                regs[label] = int(m.group(1))
    return regs


def _sass(name, lib, out_dir):
    text = subprocess.run(["cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : ", text)
    for part in parts[1:]:
        label = _kernel_label(part.split("\n", 1)[0])
        if label is None:
            continue
        body = part.split("\n", 1)[1]
        ins = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", body)
        count = lambda op: sum(1 for i in ins if i.split(".")[0] == op)
        print(f"  sass {name} {label}: {len(ins)} instructions, "
              f"LDS {count('LDS')}, FFMA {count('FFMA')}, "
              f"BRA {count('BRA')}, HGMMA {count('HGMMA')}, "
              f"UTMALDG {count('UTMALDG')}", flush=True)
        safe = re.sub(r"[^A-Za-z0-9]+", "_", label).strip("_")
        (out_dir / f"{name}_{safe}.sass").write_text(body)


def _entries(lib_path):
    """(unmasked, masked or None) C entries of a version, with or without
    the tensor-core sources' _sm90 suffix."""
    from paddle_tpu_torch.ops.kernels.flash_attention import _ARGS, _MASK_ARGS
    lib = ctypes.CDLL(str(lib_path))
    sfx = "_sm90" if hasattr(lib, "ptt_flash_attention_fwd_sm90") else ""
    plain = getattr(lib, "ptt_flash_attention_fwd" + sfx)
    plain.argtypes, plain.restype = _ARGS, ctypes.c_int
    masked = getattr(lib, "ptt_flashmask_attention_fwd" + sfx, None)
    if masked is not None:
        masked.argtypes = _ARGS[:5] + _MASK_ARGS + _ARGS[5:]
        masked.restype = ctypes.c_int
    return plain, masked


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", metavar="NAME=SRC.cu")
    ap.add_argument("--sass", metavar="DIR")
    ap.add_argument("--tol", type=float, default=None, metavar="X",
                    help="hold versions to the first within X (absolute) "
                         "instead of bit-equality")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_ab.py needs a CUDA card")
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build as b

    versions = dict(v.split("=", 1) for v in args.versions)
    print(cs._nvidia_smi(), flush=True)
    libs = _build(versions)
    for name, lib in libs.items():
        regs = _registers(lib)
        print(f"registers {name}: " + ", ".join(
            f"{k} {v}" for k, v in sorted(regs.items())), flush=True)
    if args.sass:
        sass_dir = Path(args.sass)
        sass_dir.mkdir(parents=True, exist_ok=True)
        for name, lib in libs.items():
            _sass(name, lib, sass_dir)

    dev = torch.device("cuda")
    ok = True
    for shape in SHAPES:
        bsz, s, h, d = shape
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
        lse = torch.empty(bsz, h, s, device=dev)
        none = torch.full((bsz, 1, s), s, dtype=torch.int32, device=dev)
        _, (doc_start, doc_end, _, _), _, _ = cs._flashmask_case(
            rng, dev, bsz, s, h, h, "doc")
        scale = float(d ** -0.5)

        def launcher(fn, out, bounds=None):
            head = [b.ptr(q), b.ptr(k), b.ptr(v), b.ptr(out), b.ptr(lse)]
            tail = [bsz, s, s, h, h, d, scale, 1, 1, b.stream(q)]
            if bounds is None:
                return lambda: b.check(fn(*head, *tail), "nm0")
            mask = [b.ptr(bounds[0]), b.ptr(bounds[1]), None, None, 1, 1]
            return lambda: b.check(fn(*head, *mask, *tail), "nm1")

        calls, outs = {}, {}
        for name, lib in libs.items():
            plain, masked = _entries(lib)
            cases = [("nm0", plain, None)]
            if masked is not None:
                cases += [("nm1-none", masked, (none, none)),
                          ("nm1-doc", masked, (doc_start, doc_end))]
            for case, fn, bounds in cases:
                out = torch.empty_like(q)
                calls[f"{name}:{case}"] = launcher(fn, out, bounds)
                calls[f"{name}:{case}"]()
                outs[f"{name}:{case}"] = out
        torch.cuda.synchronize()
        first = {}
        for key, out in outs.items():
            case = key.split(":")[1]
            ref = first.setdefault("nm0" if case == "nm1-none" else case, out)
            diff = (out.float() - ref.float()).abs().max().item()
            if (args.tol is None and not torch.equal(out, ref)) or \
                    (args.tol is not None and not diff <= args.tol):
                ok = False
                print(f"MISMATCH {shape} {key}: max |diff| {diff}")
            elif args.tol is not None:
                print(f"{list(shape)} {key}: max |diff| from the first "
                      f"version {diff:.3e} (<= {args.tol})")
        names = list(calls)
        times = {n: [] for n in names}
        for order in (names, names[::-1], names, names[::-1]):
            for n in order:
                times[n].append(cs._time_ms(calls[n]))
        print(f"{list(shape)} ms, mean of 4 runs (A..Z Z..A A..Z Z..A): " +
              "  ".join(
            f"{n} {sum(t) / len(t):.4f}" for n, t in times.items()),
            flush=True)
        print(f"{list(shape)} ms, each run: " + "  ".join(
            f"{n} " + "/".join(f"{x:.4f}" for x in t)
            for n, t in times.items()), flush=True)
    print("outputs bit-equal:" if args.tol is None else
          f"outputs within {args.tol} of the first version:", ok)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
