"""Which torch.distributed collectives gloo runs, on CPU and CUDA tensors,
in float32 and bfloat16, and how fast it moves data over the loopback.

    python3 tools/gloo_probe.py                 # CUDA tensors: all_reduce, broadcast
    python3 tools/gloo_probe.py all             # every op on CUDA tensors too
    python3 tools/gloo_probe.py reduce_scatter_tensor,all_gather

Starts two processes joined over gloo on 127.0.0.1 (a free port). Each op
runs once on tensors of 8 elements and prints "ok" with the first values
or the error's first line; an op that aborts the process (gloo handed a
CUDA tensor it cannot take) ends the run with the process's signal. Then
rank 0 prints the seconds of one all_reduce, reduce_scatter_tensor and
all_gather_into_tensor of 64 and 512 MB of float32 CPU tensors and, with a
card, of a 512 MB device-to-host copy into pageable and into page-locked
memory and back: the copies through which the multi-process world
(distributed.parallel_base) hands every CUDA tensor to gloo.
"""

from __future__ import annotations

import json
import shutil
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

OPS = ["all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "reduce_scatter", "all_to_all_single",
       "all_to_all", "send_recv", "isend_irecv", "gather", "scatter",
       "reduce", "barrier"]
DEFAULT_CUDA_OPS = "all_reduce,broadcast"


def run_op(op, dev, dtype, rank, world):
    x = torch.full((8,), float(rank + 1), device=dev, dtype=dtype)
    if op == "all_reduce":
        dist.all_reduce(x)
        return x.float().tolist()[:2]
    if op == "broadcast":
        dist.broadcast(x, 0)
        return x.float().tolist()[:2]
    if op == "all_gather":
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return [o[0].item() for o in out]
    if op == "all_gather_into_tensor":
        out = torch.empty(world * 8, device=dev, dtype=dtype)
        dist.all_gather_into_tensor(out, x)
        return out.float().tolist()[::8]
    if op == "reduce_scatter_tensor":
        inp = torch.arange(world * 8, device=dev, dtype=dtype) + rank
        out = torch.empty(8, device=dev, dtype=dtype)
        dist.reduce_scatter_tensor(out, inp)
        return out.float().tolist()[:2]
    if op == "reduce_scatter":
        out = torch.empty_like(x)
        dist.reduce_scatter(out, [x.clone() for _ in range(world)])
        return out.float().tolist()[:2]
    if op == "all_to_all_single":
        inp = torch.arange(world * 8, device=dev, dtype=dtype) + 100 * rank
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp)
        return out.float().tolist()[::8]
    if op == "all_to_all":
        ins = [x.clone() + i for i in range(world)]
        outs = [torch.empty_like(x) for _ in range(world)]
        dist.all_to_all(outs, ins)
        return [o[0].item() for o in outs]
    if op == "send_recv":
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)
        return x.float().tolist()[:2]
    if op == "isend_irecv":
        peer = 1 - rank
        y = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                       dist.P2POp(dist.irecv, y, peer)])
        for r in reqs:
            r.wait()
        return y.float().tolist()[:2]
    if op == "gather":
        out = [torch.empty_like(x) for _ in range(world)] if rank == 0 \
            else None
        dist.gather(x, out, dst=0)
        return [o[0].item() for o in out] if out else None
    if op == "scatter":
        ins = [x.clone() + i for i in range(world)] if rank == 0 else None
        out = torch.empty_like(x)
        dist.scatter(out, ins, src=0)
        return out.float().tolist()[:2]
    if op == "reduce":
        dist.reduce(x, 0)
        return x.float().tolist()[:2]
    if op == "barrier":
        dist.barrier()
        return "ok"
    raise ValueError(op)


def _seconds(fn):
    dist.barrier()
    t = time.perf_counter()
    fn()
    return round(time.perf_counter() - t, 4)


def rates(world):
    """Seconds of the loopback collectives and of the card's copies."""
    out = {}
    for mb in (64, 512):
        n = mb * (1 << 20) // 4
        x = torch.ones(n)
        red, gat = torch.empty(n // world), torch.empty(n * world)
        out[f"all_reduce/{mb}MB"] = _seconds(lambda: dist.all_reduce(x))
        out[f"reduce_scatter_tensor/{mb}MB"] = _seconds(
            lambda: dist.reduce_scatter_tensor(red, x))
        out[f"all_gather_into_tensor/{mb}MB"] = _seconds(
            lambda: dist.all_gather_into_tensor(gat, x))
    if torch.cuda.is_available():
        n = 512 * (1 << 20) // 2
        g = torch.ones(n, device="cuda", dtype=torch.bfloat16)
        p = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
        torch.cuda.synchronize()
        for key, fn in (("d2h_512MB_pageable", lambda: g.cpu()),
                        ("d2h_512MB_pinned", lambda: p.copy_(g)),
                        ("h2d_512MB_pinned", lambda: g.copy_(p))):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[key] = round(time.perf_counter() - t, 4)
    return out


def worker(rank, world, port, cuda_ops):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    devs = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for dev in devs:
        for dtype in (torch.float32, torch.bfloat16):
            for op in OPS:
                if dev == "cuda" and op not in cuda_ops:
                    continue
                key = f"{op}/{dev}/{str(dtype)[6:]}"
                if rank == 0:
                    print("try", key, flush=True)
                try:
                    got = ["ok", run_op(op, dev, dtype, rank, world)]
                except Exception as e:  # noqa: BLE001  (gloo's refusal)
                    got = ["ERR", f"{type(e).__name__}: "
                                  f"{str(e).splitlines()[0][:160]}"]
                if rank == 0:
                    print(key, got, flush=True)
                dist.barrier()
    got = rates(world)
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(got), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        rank, port, ops = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
        worker(rank, 2, port, OPS if ops == "all" else ops.split(","))
        return 0
    ops = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_CUDA_OPS
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r),
                               str(port), ops]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print("exit codes", rcs, flush=True)
    return max(abs(rc) for rc in rcs)


if __name__ == "__main__":
    sys.exit(main())
