"""The port's tensor-parallel engine (``paddle_tpu_torch.serving.
mesh_engine``): the counterparts of the twelve tests of
``tests/test_mesh_engine.py``, held to the JAX package.

The port's meshes put every position on the CPU (the model's device);
each shard's weights and KV pool are tensors of their own, and the
forward runs shard by shard with its all-reduces. Tokens are anchored on
the JAX SINGLE-device engine with the same weights (the JAX mesh engine's
CPU parity is a compile lottery on virtual devices, its tests say), at
tp2, tp4 with 4 KV heads, tp4 with replicated pools (GQA narrower than
the mesh), tp2 x fsdp2, int8 pools and GPT. Each case first checks that the
workload is decisive for float32 (a teacher-forced forward): every greedy
step's top-2 logit gap above 1e-5, far above the ~1e-6 by which the
shards' partial sums differ from one GEMM's (this workload's smallest gap
is ~3e-4; the JAX test's 3e-3 guard is for the reassociation of its
4-way all-reduce and the bf16 card runs, which chip_smoke.py holds to it).

Also: programs built per kind equal the port's single-device engine's run
for run and freeze after warm-up; the model's parameters are untouched;
``param_spec`` and ``make_mesh`` equal the JAX package's rules; the
gauges (labelled by mesh position); per-shard export streams byte-equal
to the JAX ``pack_pages(..., shards=2)`` over the same pages; the shard
reject matrix both ways (a JAX single-chip export refused by the mesh);
a router drill over a mixed fleet with the sharded replica killed
mid-stream (zero failed requests); the collective summary and partition
audit; a weight swap; and the dispatch-split identity of the cost ledger.

Tolerance: exact token equality; pool bytes and wire bytes exact.
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serving import kv_transfer as jkv
from paddle_tpu.serving.mesh_engine import param_spec as jparam_spec

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import weights
from paddle_tpu_torch.distributed import DeviceMesh
from paddle_tpu_torch.inference import GenerationEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.observability import sharding
from paddle_tpu_torch.observability.events import EVENTS
from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.serving import (LocalReplica, MeshGenerationEngine,
                                      Router, make_mesh, param_spec,
                                      unpack_pages)

torch.set_num_threads(1)

CFG = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
           seq=128)
# 4-way KV sharding needs kv_heads % 4 == 0
CFG4 = dict(CFG, kv_heads=4)
GCFG = dict(vocab=128, hidden=32, layers=2, heads=4, ffn=64, seq=128)
KW = dict(max_slots=4, page_size=8, max_seq_len=128, prefill_chunk=16)

_RNG = np.random.default_rng(19)
PROMPTS = [_RNG.integers(1, 127, (n,)).astype(np.int32)
           for n in (5, 11, 3, 17)]
PROMPT = _RNG.integers(1, 127, (20,)).astype(np.int32)


def _jax_model(kind="llama", cfg=CFG, seed=0):
    paddle.seed(seed)
    m = JLlama(JLlamaConfig.tiny(**cfg)) if kind == "llama" else \
        JGPT(JGPTConfig.tiny(**cfg))
    m.eval()
    return m


def _arrays(jm):
    return {n: np.asarray(p._value, np.float32)
            for n, p in jm.named_parameters()}


def _port(arrays, kind="llama", cfg=CFG):
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu") \
        if kind == "llama" else GPTForCausalLM(GPTConfig.tiny(**cfg),
                                               device="cpu")
    return weights.from_paddle_tpu_state(arrays, tm)


@pytest.fixture(scope="module")
def llama():
    """(JAX model, its weights as arrays)."""
    jm = _jax_model()
    return jm, _arrays(jm)


def _traces(e):
    return (e.decode_trace_count, e.prefill_trace_count,
            e.ragged_trace_count, e.copy_trace_count,
            e.upload_trace_count, e.spec_trace_count)


def _drain(eng, prompts, n_new):
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    out = eng.run()
    return [[int(t) for t in out[r][len(p):]]
            for r, p in zip(rids, prompts)]


def _min_greedy_margin(model, prompts, refs):
    """Smallest top-2 logit gap along the greedy paths (teacher-forced:
    causal, so positionwise the stepwise path's)."""
    mins = []
    with torch.no_grad():
        for p, ref in zip(prompts, refs):
            seq = np.concatenate([p, np.asarray(ref, np.int32)])
            v = model(torch.from_numpy(seq[None].astype(np.int64)))[0]
            for i in range(len(ref)):
                top2 = torch.sort(v[len(p) - 1 + i]).values[-2:]
                mins.append(float(top2[1] - top2[0]))
    return min(mins)


# ----------------------------------------------------------------------
# greedy parity + trace identity
# ----------------------------------------------------------------------

# case -> (model kind, config, tp, fsdp, kv_shards, kv_dtype)
_PARITY_CASES = {
    "tp2": ("llama", CFG, 2, 1, 2, None),
    "tp4-kv4": ("llama", CFG4, 4, 1, 4, None),
    "tp4-kvrep": ("llama", CFG, 4, 1, 1, None),
    "tp2fsdp2": ("llama", CFG, 2, 2, 2, None),
    "tp2-int8": ("llama", CFG, 2, 1, 2, "int8"),
    "gpt-tp2": ("gpt", GCFG, 2, 1, 2, None),
}


@pytest.mark.parametrize("case", list(_PARITY_CASES))
def test_mesh_greedy_parity_and_trace_freeze(case):
    """Greedy tokens equal the JAX single-device engine's; the programs
    built per kind track the port's single-device engine run for run and
    freeze after warm-up (run 2 may route the prefix-hit suffix both
    engines share)."""
    kind, cfg, tp, fsdp, kv_shards, kv_dtype = _PARITY_CASES[case]
    jm = _jax_model(kind, cfg)
    jeng = JaxEngine(jm, kv_dtype=kv_dtype, **KW)
    if kv_dtype is not None:
        jeng._dense_fallback = False     # the TPU program, as the port's
    want = _drain(jeng, PROMPTS, 12)
    arrays = _arrays(jm)
    model = _port(arrays, kind, cfg)
    assert _min_greedy_margin(model, PROMPTS, want) > 1e-5, \
        "workload degenerated: near-tied greedy steps make tp parity a " \
        "coin flip"
    plain = GenerationEngine(model, kv_dtype=kv_dtype, **KW)
    mesh = MeshGenerationEngine(model, mesh_devices=tp, fsdp_devices=fsdp,
                                kv_dtype=kv_dtype, **KW)
    assert mesh.mesh_devices == tp * fsdp
    assert mesh.kv_shards == kv_shards
    hist = []
    for run in range(3):
        ref = _drain(plain, PROMPTS, 12)
        got = _drain(mesh, PROMPTS, 12)
        assert got == want, f"run {run}: mesh != the JAX engine"
        assert ref == want, f"run {run}: single != the JAX engine"
        hist.append((_traces(plain), _traces(mesh)))
    for run, (tp_, tm) in enumerate(hist):
        assert tm == tp_, f"run {run}: mesh built other programs"
    assert hist[1] == hist[2], "programs not frozen after warm-up"


def test_mesh_model_params_stay_unsharded(llama):
    """The mesh engine never writes the model's parameters: same tensors,
    same addresses, same values after construction and a drain."""
    model = _port(llama[1])
    before = [(p, p.data_ptr(), p.detach().clone())
              for _, p in model.named_parameters()]
    mesh = MeshGenerationEngine(model, mesh_devices=2, **KW)
    _drain(mesh, PROMPTS[:2], 4)
    after = list(model.named_parameters())
    for (p, ptr, val), (_, q) in zip(before, after):
        assert p is q and q.data_ptr() == ptr and torch.equal(q, val)
    # the sharded forward computes the model's logits (teacher-forced)
    ids = torch.from_numpy(PROMPT[None].astype(np.int64))
    with torch.no_grad():
        np.testing.assert_allclose(mesh._fwd(ids).numpy(),
                                   model(ids).numpy(), rtol=1e-5, atol=1e-5)
    # the column-parallel pieces are tensors of their own, replicated
    # weights on the model's device are the model's tensors
    placed = {p.name: p for p in mesh._param_vals()}
    q = placed["llama.layers.0.self_attn.q_proj.weight"]
    assert [tuple(t.shape) for t in q.tensors()] == [(32, 16), (32, 16)]
    assert all(t.data_ptr() != model.llama.layers[0].self_attn.q_proj
               .weight.data_ptr() for t in q.tensors())
    emb = placed["llama.embed_tokens.weight"]
    assert [t.data_ptr() for t in emb.tensors()] == \
        [model.llama.embed_tokens.weight.data_ptr()]


def test_param_spec_rules():
    cases = [
        ("llama.layers.0.self_attn.q_proj.weight", (32, 32), 2, 1),
        ("llama.layers.0.self_attn.o_proj.weight", (32, 32), 2, 1),
        ("llama.layers.0.mlp.down_proj.weight", (64, 32), 2, 1),
        ("llama.layers.0.mlp.gate_proj.weight", (32, 64), 4, 1),
        ("llama.embed_tokens.weight", (128, 32), 2, 1),
        ("llama.norm.weight", (32,), 2, 1),
        ("lm_head.weight", (32, 128), 2, 1),
        ("llama.layers.0.self_attn.q_proj.weight", (32, 30), 4, 1),
        ("llama.layers.0.self_attn.q_proj.weight", (32, 32), 2, 2),
        ("llama.layers.0.self_attn.o_proj.weight", (32, 32), 2, 2),
        ("llama.layers.0.self_attn.k_proj.weight", (30, 16), 2, 4),
        ("gpt.h.0.attn.qkv_proj.weight", (32, 96), 2, 1),
        ("gpt.h.0.attn.out_proj.weight", (32, 32), 2, 1),
    ]
    for name, shape, tp, fsdp in cases:
        assert tuple(param_spec(name, shape, tp, fsdp)) == \
            tuple(jparam_spec(name, shape, tp, fsdp)), (name, shape, tp)
    P = tuple
    assert P(param_spec("llama.layers.0.self_attn.q_proj.weight",
                        (32, 32), 2)) == (None, "tp")
    assert P(param_spec("llama.layers.0.self_attn.o_proj.weight",
                        (32, 32), 2, fsdp=2)) == ("tp", "fsdp")
    assert P(param_spec("llama.layers.0.self_attn.q_proj.weight",
                        (32, 30), 4)) == (None, None)


def test_make_mesh_shapes_and_rejects():
    m2 = make_mesh(2, devices="cpu")
    assert m2.axis_names == ("tp",) and m2.devices.size == 2
    assert m2.co_located
    m22 = make_mesh(2, 2, devices="cpu")
    assert m22.axis_names == ("fsdp", "tp") and m22.devices.shape == (2, 2)
    with pytest.raises(ValueError):
        make_mesh(0, devices="cpu")
    with pytest.raises(ValueError):
        make_mesh(4, devices=["cpu", "cpu"])   # fewer than the mesh wants
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):       # the card by default
            make_mesh(2)
    model = _port(_arrays(_jax_model()))
    elsewhere = np.empty(2, dtype=object)
    elsewhere[0], elsewhere[1] = torch.device("cuda", 0), torch.device("cpu")
    with pytest.raises(ValueError, match="position 0"):
        MeshGenerationEngine(model, mesh_devices=2,
                             mesh=DeviceMesh(elsewhere, ("tp",)), **KW)


def test_mesh_gauges_published(llama):
    model = _port(llama[1])
    mesh = MeshGenerationEngine(model, mesh_devices=2, **KW)
    single = GenerationEngine(model, **KW)
    g = REGISTRY.snapshot()["gauges"]
    assert g.get("engine_mesh_devices") == 2
    d0 = g.get("engine_kv_pool_shard_bytes{device=0}")
    d1 = g.get("engine_kv_pool_shard_bytes{device=1}")
    assert d0 and d1 and d0 == d1               # even head split
    assert d0 + d1 == single.stats["kv_pool_bytes"] \
        == mesh.stats["kv_pool_bytes"]
    ups = EVENTS.events("engine_mesh_up")
    assert ups and ups[-1]["kv_shards"] == 2 and ups[-1]["tp"] == 2
    MeshGenerationEngine(model, mesh_devices=4, **KW)   # 2 KV heads, tp 4
    rep = EVENTS.events("engine_mesh_kv_replicated")
    assert rep and rep[-1]["n_kv_heads"] == 2 and rep[-1]["tp"] == 4


# ----------------------------------------------------------------------
# per-shard KV streams + the reject matrix at the engine boundary
# ----------------------------------------------------------------------

def test_mesh_export_frames_per_shard_streams(llama):
    """A live request's export is framed as 2 per-shard head streams,
    byte for byte what the JAX package's ``pack_pages(..., shards=2)``
    writes for the same pages."""
    model = _port(llama[1])
    mesh = MeshGenerationEngine(model, mesh_devices=2, **KW)
    rid = mesh.add_request(PROMPT, max_new_tokens=4)
    snap = None
    while snap is None:
        mesh.step()
        req = mesh._reqs.get(rid)
        if req is not None and req.n_generated >= 2:
            snap = mesh.remove_request(rid, with_kv=True)
    kv = snap["kv"]
    meta, payload = kv["meta"], kv["payload"]
    sh = meta.get("shards")
    assert sh and sh["count"] == 2
    assert sh["heads_per_shard"] * sh["count"] == meta["n_kv_heads"]
    offs = [s["offset"] for s in sh["streams"]]
    assert offs == sorted(offs) and offs[0] == 0
    assert sum(s["nbytes"] for s in sh["streams"]) == len(payload)
    k, v = unpack_pages(meta, payload, expect_shards=2)
    jmeta, jpayload = jkv.pack_pages(
        k.numpy(), v.numpy(), meta["tokens"], meta["page_size"],
        weights_tag=meta["weights_tag"], shards=2)
    assert jpayload == payload
    assert jmeta == meta
    # the pages are the single-device engine's (float32: equal values)
    single = GenerationEngine(model, **KW)
    rid = single.add_request(PROMPT, max_new_tokens=4)
    single.run()
    smeta, spayload = single.export_kv_pages(PROMPT[:16])
    k1, v1 = unpack_pages(smeta, spayload)
    np.testing.assert_allclose(k.numpy()[:, :2], k1.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(v.numpy()[:, :2], v1.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_shard_mismatch_import_refuses_then_reprefills(llama):
    """A 2-shard export refuses to map into a single-device pool (an
    accounted skip), the import re-prefills from the journal, and the
    resumed stream is exactly-once and equal to the JAX engine's."""
    n_new = 12
    jeng = JaxEngine(_jax_model(), **KW)
    want = _drain(jeng, [PROMPT], n_new)[0]
    mesh = MeshGenerationEngine(_port(llama[1]), mesh_devices=2, **KW)
    rid = mesh.import_request(
        {"tokens": [int(t) for t in PROMPT], "remaining": n_new,
         "prompt0": len(PROMPT)}, streaming=True)
    got = []
    it = mesh.stream_request(rid)
    for _cursor, tok in it:
        got.append(tok)
        if len(got) == 5:
            break
    it.close()
    snap = mesh.remove_request(rid, with_kv=True)
    assert snap["kv"]["meta"]["shards"]["count"] == 2

    single = GenerationEngine(_port(llama[1]), **KW)
    c0 = REGISTRY.counter("engine_kv_pages_imported_total").value
    rid_b = single.import_request(snap, streaming=True)
    assert REGISTRY.counter("engine_kv_pages_imported_total").value == c0
    for cursor, tok in single.stream_request(rid_b, start=len(got)):
        assert cursor == len(got)           # exactly-once, no replays
        got.append(tok)
    assert got == want
    skips = [e for e in EVENTS.events("engine_kv_import_skipped")
             if e.get("reason") == "kv_shards"]
    assert skips and skips[-1]["theirs"] == 2 and skips[-1]["ours"] == 1


def test_single_chip_export_refused_by_mesh(llama):
    """The matrix is symmetric: a 1-stream export (the JAX single-chip
    engine's, and the port's) never re-frames into a 2-shard pool."""
    jeng = JaxEngine(_jax_model(), **KW)
    jeng.add_request(PROMPT, max_new_tokens=4)
    jeng.run()
    jmeta, jpayload = jeng.export_kv_pages(PROMPT)
    assert "shards" not in jmeta
    mesh = MeshGenerationEngine(_port(llama[1]), mesh_devices=2, **KW)
    assert mesh.import_kv_pages(jmeta, jpayload) == 0
    single = GenerationEngine(_port(llama[1]), **KW)
    single.add_request(PROMPT, max_new_tokens=4)
    single.run()
    meta, payload = single.export_kv_pages(PROMPT)
    assert "shards" not in meta
    assert mesh.import_kv_pages(meta, payload) == 0
    # and a same-shard-count import adopts the pages
    other = MeshGenerationEngine(_port(llama[1]), mesh_devices=2, **KW)
    other.add_request(PROMPT, max_new_tokens=4)
    other.run()
    m2, p2 = other.export_kv_pages(PROMPT)
    assert m2["shards"]["count"] == 2
    assert mesh.import_kv_pages(m2, p2) == m2["n_pages"]


# ----------------------------------------------------------------------
# one Replica handle: the fleet plane must not notice the mesh
# ----------------------------------------------------------------------

def test_router_drill_mixed_fleet_zero_failed(llama):
    """Two replicas, one sharded: the sharded one is killed mid-decode;
    every stream completes greedy-identical (to the JAX engine) with zero
    failed requests."""
    n_new = 16
    prompts = [_RNG.integers(1, 127, (12,)).astype(np.int32)
               for _ in range(4)]
    refs = _drain(JaxEngine(_jax_model(), **KW), prompts, n_new)
    m_mesh, m_single = _port(llama[1]), _port(llama[1])
    reps = {
        "mesh0": LocalReplica(
            "mesh0", m_mesh,
            engine=MeshGenerationEngine(m_mesh, mesh_devices=2, **KW)),
        "r1": LocalReplica(
            "r1", m_single, engine=GenerationEngine(m_single, **KW)),
    }
    router = Router(reps, page_size=KW["page_size"])
    f0 = REGISTRY.counter("fleet_requests_failed_total").value
    results = [None] * len(prompts)
    mid = threading.Event()
    delivered = [0]

    def client(i):
        toks = []
        for t in router.stream(prompts[i], max_new_tokens=n_new):
            toks.append(int(t))
            delivered[0] += 1
            if delivered[0] >= 2:
                mid.set()
        results[i] = toks

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    assert mid.wait(180)
    reps["mesh0"].kill()
    for t in threads:
        t.join(300)
    assert all(r is not None and len(r) == n_new for r in results)
    assert results == refs
    assert REGISTRY.counter("fleet_requests_failed_total").value == f0


def test_local_replica_handle_is_engine_agnostic(llama):
    """A router with ONLY the mesh replica generates the JAX engine's
    tokens; ``get_engine(mesh_devices=2)`` gives the mesh engine."""
    m = _port(llama[1])
    rep = LocalReplica(
        "m0", m, engine=MeshGenerationEngine(m, mesh_devices=2, **KW))
    router = Router({"m0": rep}, page_size=KW["page_size"])
    out = router.generate(PROMPT, max_new_tokens=6)
    want = _drain(JaxEngine(_jax_model(), **KW), [PROMPT], 6)[0]
    assert [int(t) for t in out] == want
    rep.kill()
    eng = m.get_engine(mesh_devices=2, **KW)
    assert isinstance(eng, MeshGenerationEngine) and eng.kv_shards == 2
    assert type(m.get_engine(mesh_devices=1, **KW)) is GenerationEngine


# ----------------------------------------------------------------------
# the audit, in place of tools/shard_audit.py (the reference's tool)
# ----------------------------------------------------------------------

def test_shard_audit_tool(llama):
    """The links tools/shard_audit.py checks on the JAX engine, checked
    directly on the port's: mesh dispatches book the harvested bytes,
    exports carry per-shard streams, the mesh is one replica's engine,
    the harvest shows the tp2 programs' all-reduces, and the partition
    audit is green with the canonical layout proven."""
    obs.reset()
    try:
        mesh = MeshGenerationEngine(_port(llama[1]), mesh_devices=2, **KW)
        _drain(mesh, PROMPTS, 6)
        summ = sharding.collective_summary()
        progs = [n for n in summ if n.startswith("engine:")]
        assert progs and all(n.endswith(":tp2") for n in progs), progs
        assert all(summ[n]["ops"]["all-reduce"]["bytes"] > 0
                   and summ[n]["ops"]["all-reduce"]["max_group"] == 2
                   for n in progs)
        # 2 layers x (attention + MLP) all-reduces per model step
        dec = [n for n in progs if n.startswith("engine:decode:")]
        for n in dec:
            steps = int(n.split(":")[2])
            assert summ[n]["ops"]["all-reduce"]["count"] == 4 * steps
        c = REGISTRY.counter("xla_collective_dispatch_bytes_total")
        c0 = c.value
        _drain(mesh, PROMPTS, 6)
        assert c.value > c0                              # mesh_dispatch
        audit = sharding.partition_audit(mesh)
        assert audit["ok"] and not audit["violations"]
        assert audit["col_parallel_ok"] and audit["row_parallel_ok"]
        assert audit["sharded"] == 14 and audit["replicated"] == 7
        assert audit["hlo_params"]["sharded"] > 0
        mesh.add_request(PROMPT, max_new_tokens=2)
        mesh.run()
        meta, _ = mesh.export_kv_pages(PROMPT)
        assert meta["shards"]["count"] == 2              # pershard_stream
    finally:
        obs.reset()


def test_swap_weights_replaces_placements(llama):
    """swap_weights on the mesh engine re-places the new weights: its
    tokens after the swap equal a single-device engine's on the same
    swapped model (CUDA-graph addresses kept: in-place copies)."""
    model = _port(llama[1])
    mesh = MeshGenerationEngine(model, mesh_devices=2, **KW)
    single = GenerationEngine(model, **KW)
    _drain(mesh, PROMPTS[:2], 4)
    ptrs = [t.data_ptr() for t in mesh._param_tensors()]
    w = model.llama.layers[0].self_attn.o_proj.weight

    def loader():
        w.mul_(3.0)
    mesh.swap_weights(loader)
    assert [t.data_ptr() for t in mesh._param_tensors()] == ptrs
    assert _drain(mesh, PROMPTS, 8) == _drain(single, PROMPTS, 8)


# ----------------------------------------------------------------------
# device-seconds accounting
# ----------------------------------------------------------------------

def test_mesh_dispatch_split_identity_holds(llama):
    """Attributed device-seconds cover the busy counter (0.95..1.0001):
    both scale by mesh_devices at every dispatch site."""
    busy = REGISTRY.counter("engine_busy_seconds_total")
    attr = REGISTRY.counter("cost_device_seconds_total")
    b0, a0 = busy.value, attr.value
    mesh = MeshGenerationEngine(_port(llama[1]), mesh_devices=2, **KW)
    _drain(mesh, PROMPTS, 10)
    db, da = busy.value - b0, attr.value - a0
    assert db > 0
    assert 0.95 <= da / db <= 1.0001, (da, db)
