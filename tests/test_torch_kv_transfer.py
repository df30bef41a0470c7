"""The port's KV transfer plane against the JAX package's.

The codec (``paddle_tpu_torch.serving.kv_transfer``, schema kvpages/v1):

- round trips in float32, bfloat16 (bit for bit, through torch's
  ``bfloat16`` and never through a float), int8 with scale rows, and the
  sharded framing; the reject matrices (bad inputs, the scales slot, the
  shard count);
- for the same pages, ``pack_pages`` gives the JAX package's payload
  bytes and meta exactly, in every dtype, sharded or not, and each side
  unpacks the other's blob to the same bits;
- ``prefix_chain_hashes`` equals the JAX package's.

The engines (a tiny Llama, float32 weights bridged from the JAX model;
pages of 8):

- a JAX engine's ``export_kv_pages`` imported by the port's engine, and a
  port export imported by a JAX engine, each continues token-exact
  against the exporter's own continuation, in float32, bfloat16 and int8
  pools (the JAX int8 engine as the TPU runs it, ``_dense_fallback =
  False``), with the prefix hit served by the imported pages, and the
  upload program counted as JAX counts its uploads;
- ``export_request(with_kv=True)`` mid-stream: the port's ``kv`` meta is
  the JAX engine's for the same request (the page bytes differ only by
  the two forwards' float rounding), and each package resumes the other's
  snapshot exactly once and token-exact; ``remove_request(with_kv=True)``
  too;
- the refusals (weights tag, kv dtype, shard count) return 0 in both
  packages; a geometry mismatch raises;
- a pool too small for the prompts spills into a ``PrefixStore`` and
  refills from it token-exact; a ``FileStore`` fleet tier serves a page
  one engine spilled to another (the cross-replica hit).

Tolerance: exact bytes, exact meta (for the codec), exact token equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.inference import engine as jengine
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import kv_transfer as jkv

from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import GenerationEngine
from paddle_tpu_torch.inference import engine as tengine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.serving import (FileStore, PrefixStore, pack_pages,
                                      unpack_pages, unpack_scales)

torch.set_num_threads(1)

CFG = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
           seq=128)
KW = dict(max_slots=4, page_size=8, max_seq_len=128, prefill_chunk=16,
          mixed_step=False)
PAGE = KW["page_size"]

_RNG = np.random.default_rng(7)
PROMPT_ALIGNED = _RNG.integers(1, 127, (24,)).astype(np.int32)  # 3 pages
PROMPT_PARTIAL = _RNG.integers(1, 127, (27,)).astype(np.int32)  # 3 + 3


def _counter(name):
    return REGISTRY.counter(name).value


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny(**CFG))
    jm.eval()
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    weights.from_paddle_tpu_state(arrays, tm)
    return jm, tm


def _jax_engine(jm, kv=None, **over):
    kw = dict(KW, **over)
    if kv == "bfloat16":
        kw["cache_dtype"] = jnp.bfloat16
    eng = jengine.GenerationEngine(jm, kv_dtype="int8" if kv == "int8"
                                   else None, **kw)
    if kv == "int8":
        eng._dense_fallback = False     # the TPU program's int8 decode
    return eng


def _port_engine(tm, kv=None, **over):
    kw = dict(KW, **over)
    if kv == "bfloat16":
        kw["cache_dtype"] = torch.bfloat16
    return GenerationEngine(tm, kv_dtype="int8" if kv == "int8" else None,
                            **kw)


def _run(eng, prompt, n_new):
    rid = eng.add_request(prompt, max_new_tokens=n_new)
    return [int(t) for t in eng.run()[rid][len(prompt):]]


# ----------------------------------------------------------------------
# codec
# ----------------------------------------------------------------------

def _page_batch(dtype, n_layers=2, n_pages=3, page=8, heads=2, dim=4):
    shape = (n_layers, n_pages, page, heads, dim)
    k = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) / 7.0
    return k.astype(dtype), (k * -0.5 + 1).astype(dtype)


def _toks(n_pages=3, page=8):
    return list(range(1, n_pages * page + 1))


def test_pack_unpack_roundtrip_f32():
    k, v = _page_batch(np.float32)
    meta, payload = pack_pages(torch.from_numpy(k), torch.from_numpy(v),
                               _toks(), 8, weights_tag="step3")
    assert meta["schema"] == "kvpages/v1" and meta["dtype"] == "float32"
    assert meta["layout"] == "l.p.s.h.d" and meta["weights_tag"] == "step3"
    assert meta["nbytes"] == len(payload) == 2 * k.nbytes
    k2, v2 = unpack_pages(meta, payload)
    assert k2.dtype == torch.float32
    np.testing.assert_array_equal(k2.numpy(), k)
    np.testing.assert_array_equal(v2.numpy(), v)
    # numpy input packs the same bytes
    assert pack_pages(k, v, _toks(), 8, weights_tag="step3") \
        == (meta, payload)


def test_pack_unpack_roundtrip_bf16_bit_exact():
    k, v = _page_batch(np.float32)
    tk, tv = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    meta, payload = pack_pages(tk, tv, _toks(), 8)
    assert meta["dtype"] == "bfloat16"
    assert len(payload) == 2 * tk.numel() * 2       # 2 bytes a value
    k2, v2 = unpack_pages(meta, payload)
    assert k2.dtype == torch.bfloat16
    assert torch.equal(k2.view(torch.int16), tk.view(torch.int16))
    assert torch.equal(v2.view(torch.int16), tv.view(torch.int16))
    # the same pages as uint16 bits with an explicit dtype name
    bits_k = tk.view(torch.int16).numpy().view(np.uint16)
    bits_v = tv.view(torch.int16).numpy().view(np.uint16)
    assert pack_pages(bits_k, bits_v, _toks(), 8, dtype="bfloat16") \
        == (meta, payload)


def test_pack_unpack_roundtrip_int8_with_scales():
    k, v = _page_batch(np.float32)
    k8 = np.clip(np.round(k), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(v * 3), -127, 127).astype(np.int8)
    ks = np.linspace(0.01, 2.0, 6, dtype=np.float32).reshape(2, 3)
    vs = (ks * 1.5).astype(np.float32)
    meta, payload = pack_pages(torch.from_numpy(k8), torch.from_numpy(v8),
                               _toks(), 8, k_scales=torch.from_numpy(ks),
                               v_scales=vs)
    assert meta["dtype"] == "int8" and len(payload) == 2 * k8.nbytes
    k2, v2 = unpack_pages(meta, payload)
    np.testing.assert_array_equal(k2.numpy(), k8)
    np.testing.assert_array_equal(v2.numpy(), v8)
    ks2, vs2 = unpack_scales(meta)
    np.testing.assert_array_equal(ks2, ks)          # f32 exact over JSON
    np.testing.assert_array_equal(vs2, vs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sharded_framing_roundtrip(dtype):
    k, v = _page_batch(np.float32, heads=4)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    kw = {}
    if dtype == "bfloat16":
        tk, tv = tk.bfloat16(), tv.bfloat16()
    elif dtype == "int8":
        tk, tv = tk.to(torch.int8), tv.to(torch.int8)
        kw = dict(k_scales=np.ones((2, 3), np.float32),
                  v_scales=np.full((2, 3), 0.5, np.float32))
    meta, payload = pack_pages(tk, tv, _toks(), 8, shards=2, **kw)
    sh = meta["shards"]
    assert sh["count"] == 2 and sh["heads_per_shard"] == 2
    assert [s["offset"] for s in sh["streams"]] == [0, len(payload) // 2]
    k2, v2 = unpack_pages(meta, payload, expect_shards=2)
    assert torch.equal(k2, tk) and torch.equal(v2, tv)
    with pytest.raises(ValueError, match="shard"):
        unpack_pages(meta, payload, expect_shards=1)
    flat_meta, _ = pack_pages(tk, tv, _toks(), 8, **kw)
    assert "shards" not in flat_meta                # shards=1: no block


def test_pack_rejects_bad_inputs():
    k, v = _page_batch(np.float32)
    with pytest.raises(ValueError, match="full pages"):
        pack_pages(k, v, _toks()[:-1], 8)
    with pytest.raises(ValueError, match="page_size"):
        pack_pages(k, v, _toks(), 4)
    with pytest.raises(ValueError, match="shapes"):
        pack_pages(k, v[:, :2], _toks(), 8)
    with pytest.raises(ValueError, match="not serializable"):
        pack_pages(torch.from_numpy(k).half(), torch.from_numpy(v).half(),
                   _toks(), 8)
    with pytest.raises(ValueError, match="not serializable"):
        pack_pages(k.astype(np.float64), v.astype(np.float64), _toks(), 8)
    with pytest.raises(ValueError, match="kv heads do not split"):
        pack_pages(k, v, _toks(), 8, shards=3)
    meta, payload = pack_pages(k, v, _toks(), 8)
    with pytest.raises(ValueError, match="schema"):
        unpack_pages(dict(meta, schema="kvpages/v0"), payload)
    with pytest.raises(ValueError, match="bytes"):
        unpack_pages(meta, payload[:-4])
    flipped = bytearray(payload)
    flipped[5] ^= 0x10
    with pytest.raises(ValueError, match="checksum"):
        unpack_pages(meta, bytes(flipped))


def test_scales_slot_reject_matrix():
    k, v = _page_batch(np.float32)
    k8, v8 = k.astype(np.int8), v.astype(np.int8)
    ones = np.ones((2, 3), np.float32)
    with pytest.raises(ValueError, match="need scales"):
        pack_pages(k8, v8, _toks(), 8)              # int8 without scales
    with pytest.raises(ValueError, match="shape"):
        pack_pages(k8, v8, _toks(), 8, k_scales=ones[:, :2],
                   v_scales=ones)
    with pytest.raises(ValueError, match="only rides int8"):
        pack_pages(k, v, _toks(), 8, k_scales=ones, v_scales=ones)
    meta, payload = pack_pages(k8, v8, _toks(), 8, k_scales=ones,
                               v_scales=ones)
    with pytest.raises(ValueError, match="need scales"):
        unpack_pages(dict(meta, scales=None), payload)
    fmeta, fpayload = pack_pages(k, v, _toks(), 8)
    with pytest.raises(ValueError, match="only rides int8"):
        unpack_scales(dict(fmeta, scales=meta["scales"]))
    assert unpack_scales(fmeta) == (None, None)


def _jax_bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_pack_pages_bytes_and_meta_equal_jax(dtype, shards):
    """The wire is the JAX package's: the same pages give the same payload
    bytes and the same meta, and each side unpacks the other's blob to
    the same bits."""
    k, v = _page_batch(np.float32, heads=4)
    kw = {}
    if dtype == "float32":
        jk, jv = k, v
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    elif dtype == "bfloat16":
        jk, jv = _jax_bf16(k), _jax_bf16(v)
        tk, tv = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    else:
        jk = np.clip(np.round(k * 5), -127, 127).astype(np.int8)
        jv = np.clip(np.round(v * 5), -127, 127).astype(np.int8)
        tk, tv = torch.from_numpy(jk), torch.from_numpy(jv)
        kw = dict(k_scales=np.float32([[0.1, 0.2, 0.3], [1e-3, 7.5, 1.0]]),
                  v_scales=np.float32([[2.0, 0.25, 3.3], [0.7, 0.6, 0.5]]))
    jmeta, jpayload = jkv.pack_pages(jk, jv, _toks(), 8, weights_tag="step5",
                                     shards=shards, **kw)
    tmeta, tpayload = pack_pages(tk, tv, _toks(), 8, weights_tag="step5",
                                 shards=shards, **kw)
    assert tmeta == jmeta
    assert tpayload == jpayload
    # the port reads JAX's blob, and JAX the port's, to the same bits
    pk, pv = unpack_pages(jmeta, jpayload, expect_shards=shards)
    assert torch.equal(pk, tk) and torch.equal(pv, tv)
    qk, qv = jkv.unpack_pages(tmeta, tpayload, expect_shards=shards)
    np.testing.assert_array_equal(np.asarray(qk).view(np.uint8),
                                  np.asarray(jk).view(np.uint8))
    np.testing.assert_array_equal(np.asarray(qv).view(np.uint8),
                                  np.asarray(jv).view(np.uint8))


def test_prefix_chain_hashes_equal_across_packages():
    for toks in (PROMPT_ALIGNED, PROMPT_PARTIAL, np.arange(5),
                 np.arange(1000) % 97):
        for page in (4, 8, 16):
            got = tengine.prefix_chain_hashes(toks, page)
            assert got == jengine.prefix_chain_hashes(toks, page)
            assert len(got) == len(toks) // page


# ----------------------------------------------------------------------
# engines: the port against the JAX package, both ways
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kv", [None, "bfloat16", "int8"],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_kv_import_continues_token_exact(pair, kv, direction):
    jm, tm = pair
    prompt = PROMPT_PARTIAL
    if direction == "jax_to_port":
        src, dst = _jax_engine(jm, kv), _port_engine(tm, kv)
    else:
        src, dst = _port_engine(tm, kv), _jax_engine(jm, kv)
    ref = _run(src, prompt, 12)                     # the exporter's own
    meta, payload = src.export_kv_pages(prompt, trace="t-x")
    assert meta["n_pages"] == len(prompt) // PAGE
    assert meta["dtype"] == {None: "float32", "bfloat16": "bfloat16",
                             "int8": "int8"}[kv]
    assert dst.import_kv_pages(meta, payload, trace="t-x") \
        == meta["n_pages"]
    assert dst.upload_trace_count == 1
    hits0 = _counter("engine_prefix_cache_hit_tokens_total")
    assert _run(dst, prompt, 12) == ref
    if direction == "jax_to_port":                  # the port's registry
        assert _counter("engine_prefix_cache_hit_tokens_total") - hits0 \
            == meta["n_pages"] * PAGE


def test_upload_program_counts_as_jax_counts(pair):
    """One upload program per (power-of-two page count, staged dtype): a
    repeat of a bucket builds none, like the JAX engine's jit cache. The
    imports adopt 3, 1, 2 and 3 new pages: buckets 4, 1, 2 and 4 again."""
    jm, tm = pair
    src = _port_engine(tm)
    other = np.concatenate([PROMPT_ALIGNED[::-1], [5]])
    for p in (PROMPT_ALIGNED, PROMPT_PARTIAL, other):
        _run(src, p, 4)
    engines = (_port_engine(tm), _jax_engine(jm))
    for toks in (PROMPT_ALIGNED, PROMPT_PARTIAL[:PAGE], PROMPT_PARTIAL,
                 other):
        meta, payload = src.export_kv_pages(toks)
        for eng in engines:
            eng.import_kv_pages(meta, payload)
    assert [e.upload_trace_count for e in engines] == [3, 3]


def test_export_request_with_kv_midstream_equals_jax_and_crosses(pair):
    """A live request exported with its KV after 3 delivered tokens: the
    port's ``kv`` meta is the JAX engine's for the same request (bytes
    differ only by float rounding), and each package resumes the other's
    snapshot exactly once and token-exact."""
    jm, tm = pair
    prompt = PROMPT_PARTIAL
    ref = _run(_jax_engine(jm), prompt, 16)
    snaps = {}
    for name, eng in (("jax", _jax_engine(jm)), ("port", _port_engine(tm))):
        rid = eng.add_request(prompt, max_new_tokens=16)
        it = eng.stream_request(rid, 0)
        first = [next(it)[1] for _ in range(3)]
        it.close()
        assert first == ref[:3]
        snaps[name] = eng.export_request(rid, with_kv=True)
        assert "kv" in snaps[name]
    jmeta = dict(snaps["jax"]["kv"]["meta"])
    tmeta = dict(snaps["port"]["kv"]["meta"])
    assert jmeta.pop("crc32") is not None and tmeta.pop("crc32") is not None
    assert tmeta == jmeta
    assert tmeta["n_pages"] >= len(prompt) // PAGE
    for name, dst in (("jax", _port_engine(tm)), ("port", _jax_engine(jm))):
        rid = dst.import_request(snaps[name])
        rest = [tok for _, tok in dst.stream_request(rid, 3)]
        assert ref[:3] + rest == ref
        assert dst.upload_trace_count == 1          # the pages were mapped


def test_remove_request_with_kv_moves_pages(pair):
    jm, tm = pair
    ref = _run(_port_engine(tm), PROMPT_ALIGNED, 12)
    src = _port_engine(tm)
    rid = src.add_request(PROMPT_ALIGNED, max_new_tokens=12)
    it = src.stream_request(rid, 0)
    first = [next(it)[1] for _ in range(2)]
    it.close()
    exp0 = _counter("engine_kv_pages_exported_total")
    snap = src.remove_request(rid, with_kv=True)
    assert _counter("engine_kv_pages_exported_total") - exp0 \
        == snap["kv"]["meta"]["n_pages"] >= 3
    assert rid not in src._reqs and not src.has_work()
    dst = _jax_engine(jm)
    rid2 = dst.import_request(snap)
    rest = [tok for _, tok in dst.stream_request(rid2, len(first))]
    assert first + rest == ref


@pytest.mark.parametrize("reason", ["weights_tag", "kv_dtype", "kv_shards"])
def test_import_refusals_return_zero_in_both_packages(pair, reason):
    jm, tm = pair
    src = _port_engine(tm, "int8" if reason == "kv_dtype" else None)
    _run(src, PROMPT_ALIGNED, 4)
    meta, payload = src.export_kv_pages(PROMPT_ALIGNED)
    if reason == "kv_shards":
        k, v = unpack_pages(meta, payload)
        meta, payload = pack_pages(k, v, meta["tokens"], PAGE, shards=2)
    dsts = (_port_engine(tm), _jax_engine(jm))
    if reason == "weights_tag":
        for d in dsts:
            d.swap_weights(lambda: None, tag="step7")
    imp0 = _counter("engine_kv_pages_imported_total")
    assert [d.import_kv_pages(meta, payload) for d in dsts] == [0, 0]
    assert _counter("engine_kv_pages_imported_total") == imp0
    assert [d.upload_trace_count for d in dsts] == [0, 0]


def test_weights_tag_match_flows_again(pair):
    jm, tm = pair
    src, dst = _port_engine(tm), _port_engine(tm)
    for e in (src, dst):
        e.swap_weights(lambda: None, tag="step7")
    _run(src, PROMPT_ALIGNED, 4)
    meta, payload = src.export_kv_pages(PROMPT_ALIGNED)
    assert meta["weights_tag"] == "step7"
    assert dst.import_kv_pages(meta, payload) == 3
    assert dst.import_kv_pages(meta, payload) == 0  # already resident
    assert dst.blocks.free_pages == dst.blocks.n_pages - 1  # reclaimable


def test_import_kv_rejects_mismatched_geometry(pair):
    jm, tm = pair
    src = _jax_engine(jm)
    _run(src, PROMPT_ALIGNED, 4)
    meta, payload = src.export_kv_pages(PROMPT_ALIGNED)
    other = _port_engine(tm, page_size=16)
    with pytest.raises(ValueError, match="does not fit"):
        other.import_kv_pages(meta, payload)


def test_export_kv_refused_for_pre_swap_sequence(pair):
    """A sequence admitted before a weight swap exports no KV (its pages
    predate the swap); one admitted after exports under the new tag."""
    _, tm = pair
    src = _port_engine(tm)
    rid = src.add_request(PROMPT_ALIGNED, 16)
    it = src.stream_request(rid, 0)
    next(it), next(it)
    it.close()
    src.swap_weights(lambda: None, tag="step9")
    assert "kv" not in src.remove_request(rid, with_kv=True)
    r2 = src.add_request(PROMPT_ALIGNED, 16)
    it2 = src.stream_request(r2, 0)
    next(it2)
    it2.close()
    assert src.remove_request(r2, with_kv=True)["kv"]["meta"][
        "weights_tag"] == "step9"


def _churn(eng, seed, n=6):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        _run(eng, rng.integers(1, 127, (40,)).astype(np.int32), 4)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_spill_refill_under_small_pool(pair, kv):
    """A pool too small for the prompts evicts prefix pages into the
    PrefixStore; a later admission refills them and the tokens equal a
    cold JAX engine's."""
    jm, tm = pair
    ref = _run(_jax_engine(jm, kv), PROMPT_ALIGNED, 6)
    ps = PrefixStore()
    eng = _port_engine(tm, kv, max_slots=2, n_pages=20, prefix_store=ps)
    assert _run(eng, PROMPT_ALIGNED, 6) == ref
    spill0 = _counter("engine_kv_pages_spilled_total")
    _churn(eng, 3)
    assert _counter("engine_kv_pages_spilled_total") > spill0
    assert len(ps) > 0
    refill0 = _counter("engine_kv_pages_refilled_total")
    assert _run(eng, PROMPT_ALIGNED, 6) == ref
    assert _counter("engine_kv_pages_refilled_total") > refill0


def test_fleet_prefix_store_cross_replica_hit(pair, tmp_path):
    """Engine A prefills a prompt and spills it under pressure; engine B,
    sharing only the FileStore tier, refills the pages A computed."""
    jm, tm = pair
    ref = _run(_jax_engine(jm), PROMPT_ALIGNED, 6)
    fs = FileStore(str(tmp_path))
    a = _port_engine(tm, max_slots=2, n_pages=20,
                     prefix_store=PrefixStore(store=fs))
    b = _port_engine(tm, max_slots=2, n_pages=20,
                     prefix_store=PrefixStore(store=fs))
    _run(a, PROMPT_ALIGNED, 6)
    _churn(a, 5)
    assert a.prefix_store.flush(timeout=30.0)       # async fleet writes
    fleet0 = _counter("kv_store_fleet_hits_total")
    refill0 = _counter("engine_kv_pages_refilled_total")
    assert _run(b, PROMPT_ALIGNED, 6) == ref
    assert _counter("engine_kv_pages_refilled_total") > refill0
    assert _counter("kv_store_fleet_hits_total") > fleet0


def test_swap_invalidates_the_stores_old_tag(pair):
    _, tm = pair
    ps = PrefixStore()
    eng = _port_engine(tm, max_slots=2, n_pages=20, prefix_store=ps)
    _run(eng, PROMPT_ALIGNED, 6)
    _churn(eng, 3)
    assert len(ps) > 0
    eng.swap_weights(lambda: None, tag="step1")
    assert len(ps) == 0                             # the old tag's pages
