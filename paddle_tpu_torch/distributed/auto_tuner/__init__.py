"""The auto-tuner: the counterpart of
``paddle_tpu/distributed/auto_tuner/__init__.py:21-235`` (ref:
python/paddle/distributed/auto_tuner/{tuner,search,prune,recorder,
cost_model,memory_cost_model}.py): a search over parallel configurations
(dp, mp, pp, sharding, micro-batch, recompute) with an analytic memory
model and a roofline step-time model, and ``measure_memory`` for one
candidate's step.

- the memory model knows the ZeRO stages as ``distributed._zero``
  implements them (stage 1: optimizer state sharded; stage 2: and the
  gradients; stage 3: and the parameters, gathered on use);
- the cost model is a roofline over tensor-core flops and interconnect
  bytes; its default profile is the H100's (``HARDWARE["h100"]``); the
  JAX package's profiles keep their keys, and the same inputs give the
  same estimates and ranking as there;
- ``measure_memory`` runs one candidate step and reads the peak bytes
  (the card's allocator statistics, or torch's memory tracker on the
  CPU) where the JAX package asks XLA's compile-time analysis.
"""

from __future__ import annotations

import torch


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


# --------------------------------------------------------------------------
# hardware profiles (per device)
# --------------------------------------------------------------------------

HARDWARE = {
    # name: (bf16 dense TFLOP/s, HBM GiB, interconnect GB/s)
    "v5e": (197.0, 16.0, 186.0),
    "v5p": (459.0, 95.0, 600.0),
    "v4": (275.0, 32.0, 300.0),
    # NVIDIA H100 SXM5 data sheet: 989 TFLOP/s bf16 dense (1,979 with
    # sparsity), 80 GB of HBM3 (the card reports 81,559 MiB), NVLink 900
    # GB/s a GPU (18 fourth-generation links)
    "h100": (989.0, 80.0, 900.0),
}
DEFAULT_HARDWARE = "h100"


def _profile(hardware):
    if isinstance(hardware, (tuple, list)):
        return tuple(hardware)
    if hardware not in HARDWARE:
        raise ValueError(f"hardware {hardware!r}: one of "
                         f"{sorted(HARDWARE)} or a (TFLOP/s, HBM GiB, "
                         "GB/s) tuple")
    return HARDWARE[hardware]


class MemoryCostModel:
    """Per-device HBM bytes for one config
    (ref: auto_tuner/memory_cost_model.py, adapted to the ZeRO stages as
    implemented in dist.ShardingStage1/2/3)."""

    def __init__(self, n_params, layers, hidden, vocab=32000,
                 param_bytes=2.0, master_bytes=4.0, opt_state_bytes=8.0,
                 grad_bytes=2.0):
        self.n_params = float(n_params)
        self.layers = layers
        self.hidden = hidden
        self.vocab = vocab
        self.param_bytes = param_bytes        # bf16 weights
        self.master_bytes = master_bytes      # fp32 master copy
        self.opt_state_bytes = opt_state_bytes  # adam m+v fp32
        self.grad_bytes = grad_bytes

    def estimate(self, cfg, micro_bsz, seq, recompute=True,
                 sharding_stage=1):
        mp = cfg.get("mp_degree", 1)
        pp = cfg.get("pp_degree", 1)
        sh = max(cfg.get("sharding_degree", 1), 1)
        model_shard = mp * pp                  # TP+PP split of the weights
        p = self.n_params / model_shard
        param_mem = p * self.param_bytes / (sh if sharding_stage >= 3 else 1)
        grad_mem = p * self.grad_bytes / (sh if sharding_stage >= 2 else 1)
        opt_mem = p * (self.master_bytes + self.opt_state_bytes) / sh
        # activations: per layer ~ s*b*h*(34 + 5*a*s/h) bytes for a
        # transformer block in bf16 (Korthikanti et al.); full remat keeps
        # ~2 boundaries per layer instead
        act_per_layer = micro_bsz * seq * self.hidden * (4 if recompute
                                                         else 34)
        act_mem = act_per_layer * self.layers / (mp * pp)
        # pp warmup holds up to pp in-flight microbatches of stage acts
        act_mem *= min(pp, 2)
        logits_mem = micro_bsz * seq * self.vocab * 4 / mp
        return param_mem + grad_mem + opt_mem + act_mem + logits_mem


class CostModel:
    """Analytic step time (ref: auto_tuner/cost_model.py) as a roofline:
    compute = 6*N*B*S flops over the card's tensor-core rate at an
    assumed MFU; comm = the TP all-reduces and the DP / sharding gradient
    bytes over the interconnect; the PP bubble multiplies. `hardware`: a
    HARDWARE name or a measured (TFLOP/s, HBM GiB, GB/s) profile."""

    def __init__(self, n_params, layers, hidden, hardware=DEFAULT_HARDWARE,
                 mfu_assumed=0.45):
        self.n_params = float(n_params)
        self.layers = layers
        self.hidden = hidden
        flops, hbm, ici = _profile(hardware)
        self.flops = flops * 1e12 * mfu_assumed
        self.ici = ici * 1e9        # interconnect bytes/s
        self.hbm_gib = hbm

    def step_time(self, cfg, micro_bsz, seq, global_bsz, recompute=True):
        dp = cfg.get("dp_degree", 1)
        mp = cfg.get("mp_degree", 1)
        pp = cfg.get("pp_degree", 1)
        acc = max(global_bsz // (dp * micro_bsz), 1)
        tokens = global_bsz * seq
        mult = 4 if recompute else 3   # fwd + bwd (+ refwd)
        compute = (2.0 * mult * self.n_params * tokens /
                   (self.flops * dp * mp * pp))
        # TP: 2 all-reduces of activations a layer forward (+2 backward),
        # ring cost
        act_bytes = micro_bsz * seq * self.hidden * 2.0
        tp_comm = (0 if mp == 1 else
                   4 * self.layers / pp * act_bytes *
                   2 * (mp - 1) / mp / self.ici * acc)
        # DP / sharding gradient sync: 2 bytes a parameter, reduce-scatter
        # and all-gather
        grad_bytes = 2.0 * self.n_params / (mp * pp)
        dp_comm = (0 if dp == 1 else
                   2 * grad_bytes * (dp - 1) / dp / self.ici)
        bubble = (pp - 1) / max(acc + pp - 1, 1)
        return (compute + tp_comm) * (1 + bubble) + dp_comm


# --------------------------------------------------------------------------
# pruning (ref: auto_tuner/prune.py rule registry)
# --------------------------------------------------------------------------

class Prune:
    def __init__(self, max_mem_bytes=None, hidden=None, layers=None,
                 n_heads=None):
        self.max_mem_bytes = max_mem_bytes
        self.hidden = hidden
        self.layers = layers
        self.n_heads = n_heads

    def ok(self, cfg, est_mem):
        mp = cfg.get("mp_degree", 1)
        pp = cfg.get("pp_degree", 1)
        if self.max_mem_bytes is not None and est_mem > self.max_mem_bytes:
            return False
        if self.hidden is not None and self.hidden % mp:
            return False      # TP must divide hidden (ref prune rule)
        if self.n_heads is not None and self.n_heads % mp:
            return False
        if self.layers is not None and self.layers % pp:
            return False      # PP must divide layer count
        return True


class Recorder:
    """ref: auto_tuner/recorder.py — sorted trial history."""

    def __init__(self):
        self.history = []

    def add(self, cfg, metric, mem):
        import bisect
        entry = {"cfg": cfg, "time": metric, "mem": mem}
        bisect.insort(self.history, entry, key=lambda r: r["time"])

    def extend(self, entries):
        self.history.extend({"cfg": c, "time": t, "mem": m}
                            for t, c, m in entries)
        self.history.sort(key=lambda r: r["time"])

    def best(self):
        return self.history[0] if self.history else None


def _tensors(args):
    return [a for a in args if torch.is_tensor(a)]


def measure_memory(fn, *example_args, device=None):
    """Peak bytes of one call fn(*example_args) (a candidate's step), the
    counterpart of the JAX package's compiled-program memory analysis.
    On a CUDA device: ``torch.cuda.max_memory_allocated`` after
    ``reset_peak_memory_stats``, everything the process holds on the
    card at the peak (the arguments, the model and the temporaries). On
    the CPU: torch's ``MemTracker``
    (``torch.distributed._tools.mem_tracker``), which counts the storages
    made during the call and those of the modules, optimizers and
    tensors among the arguments. `device`: the device the call runs on
    (default: the first tensor argument's, else the first module's
    parameters'). Any other device raises."""
    if device is None:
        for a in example_args:
            if torch.is_tensor(a):
                device = a.device
                break
            if isinstance(a, torch.nn.Module):
                p = next(a.parameters(), None)
                if p is not None:
                    device = p.device
                    break
    if device is None:
        raise ValueError("measure_memory: no tensor or module among the "
                         "arguments to tell the device; pass device=")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        fn(*example_args)
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    if device.type == "cpu":
        from torch.distributed._tools.mem_tracker import MemTracker
        mt = MemTracker()
        external = [a for a in example_args
                    if torch.is_tensor(a) or isinstance(
                        a, (torch.nn.Module, torch.optim.Optimizer))]
        if external:
            mt.track_external(*external)
        with mt:
            fn(*example_args)
        snap = mt.get_tracker_snapshot("peak")
        return int(snap.get(device, {}).get("Total", 0))
    raise ValueError(f"measure_memory: no memory tracker for device "
                     f"{device}")


class AutoTuner:
    """ref: auto_tuner/tuner.py — enumerate (dp, mp, pp, sharding,
    micro_bsz, recompute), prune by the memory model, rank by the cost
    model; ``measure_memory`` measures a candidate's step."""

    def __init__(self, world_size, n_params, seq, hidden, layers,
                 global_bsz=None, max_mem_bytes=None, vocab=32000,
                 n_heads=None, hardware=DEFAULT_HARDWARE,
                 sharding_stage=1):
        self.world_size = world_size
        self.n_params = n_params
        self.seq, self.hidden, self.layers = seq, hidden, layers
        self.vocab = vocab
        self.global_bsz = global_bsz or 8
        self.sharding_stage = sharding_stage
        if max_mem_bytes is None:
            max_mem_bytes = _profile(hardware)[1] * 2**30 * 0.9
        self.mem_model = MemoryCostModel(n_params, layers, hidden, vocab)
        self.cost_model = CostModel(n_params, layers, hidden, hardware)
        self.prune = Prune(max_mem_bytes, hidden, layers, n_heads)
        self.recorder = Recorder()
        self.history = []

    def candidates(self):
        out = []
        for mp in _divisors(self.world_size):
            for pp in _divisors(self.world_size // mp):
                dp = self.world_size // (mp * pp)
                for sharding in _divisors(dp):
                    for micro in (1, 2, 4, 8):
                        if self.global_bsz % (dp * micro):
                            continue
                        for recompute in (False, True):
                            cfg = {"dp_degree": dp, "mp_degree": mp,
                                   "pp_degree": pp,
                                   "sharding_degree": sharding,
                                   "micro_batch_size": micro,
                                   "recompute": recompute}
                            est = self.mem_model.estimate(
                                cfg, micro, self.seq, recompute,
                                self.sharding_stage)
                            if self.prune.ok(cfg, est):
                                out.append((cfg, est))
        return out

    def cost(self, cfg):
        return self.cost_model.step_time(
            cfg, cfg["micro_batch_size"], self.seq, self.global_bsz,
            cfg.get("recompute", True))

    def search(self, top_k=5):
        ranked = sorted(((self.cost(c), c, m)
                         for c, m in self.candidates()),
                        key=lambda t: t[0])
        self.history = ranked
        self.recorder = Recorder()   # fresh per search (no duplicates)
        self.recorder.extend(ranked)
        return [c for _, c, _ in ranked[:top_k]]
