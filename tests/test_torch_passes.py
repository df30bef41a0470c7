"""``paddle_tpu_torch.distributed.passes`` and the fusion audit.

- the distributed passes share the graph compiler's registry and
  PassManager (the JAX package's arrangement);
- ``new_pass`` of a graph alias (``fused_attention``) returns an
  applicator whose ``apply_graph`` rewrites a captured program onto the
  flash kernel's op (its output equal to the unfused program's at 1e-6,
  float32), while the program-based ``apply`` warns where the switch is;
  a name with no graph pass stays the documented no-op and warns;
- ``fusion_audit_torch.py`` passes on the port's Llama and GPT (their
  kernels already nodes of the capture) and on the plain-op Llama (every
  site a rewrite), and fails when an architecture floor is not met.
"""

import importlib.util
import math
import os
import warnings

import numpy as np
import torch

from paddle_tpu_torch import compiler
from paddle_tpu_torch.distributed import passes as dpasses


def _attn(q, k, v):
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    logits = torch.einsum("bhsd,bhtd->bhst", qt, kt) / math.sqrt(8)
    s, t = logits.shape[-2:]
    cm = torch.ones(s, t, dtype=torch.bool).tril(t - s)
    logits = torch.where(cm, logits, torch.tensor(-1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, vt).transpose(1, 2)


def test_shared_registry_exposed():
    assert dpasses.PassManager is compiler.PassManager
    assert dpasses.PASS_REGISTRY is compiler.PASS_REGISTRY
    for name in ("pattern_fusion", "dce", "cse", "constant_fold",
                 "remat_tag"):
        assert name in dpasses.PASS_REGISTRY
    assert set(dpasses.GRAPH_PASS_ALIASES.values()) <= \
        set(dpasses.PASS_REGISTRY)


def test_new_pass_graph_alias_applies():
    p = dpasses.new_pass("fused_attention")
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 2, 8)).astype(
        np.float32)) for _ in range(3))
    gm, _ = compiler.capture(_attn, [q, k, v])
    out = p.apply_graph(gm, program="dist_pass")
    targets = [n.target for n in out.graph.nodes]
    assert torch.ops.ptt.flash_attention_fwd.default in targets
    assert torch.ops.aten._softmax.default not in targets    # DCE'd
    np.testing.assert_allclose(out(q, k, v)[0].numpy(),
                               _attn(q, k, v).numpy(), atol=1e-6)
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        p.apply()
    assert any("graph compiler" in str(x.message) for x in wlog)
    assert dpasses.new_pass("recompute_tagging").graph_pass_name == \
        "remat_tag"


def test_new_pass_legacy_still_warns():
    p = dpasses.new_pass("auto_parallel_amp")
    assert not hasattr(p, "apply_graph")
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        p.apply()
    assert any("no-op" in str(x.message) for x in wlog)


def _load_audit():
    spec = importlib.util.spec_from_file_location(
        "fusion_audit_torch", os.path.join(os.path.dirname(__file__), "..",
                                           "fusion_audit_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fusion_audit_passes(capsys):
    fa = _load_audit()
    rc = fa.main([])
    out = capsys.readouterr().out
    assert rc == 0
    for line in ("model=llama pattern=attention found=0 applied=0 missed=0 "
                 "kernel_nodes=2 expected=2 [ok]",
                 "model=llama pattern=rope found=0 applied=0 missed=0 "
                 "kernel_nodes=4 expected=4 [ok]",
                 "model=gpt pattern=attention found=0 applied=0 missed=0 "
                 "kernel_nodes=2 expected=2 [ok]",
                 "model=plain_llama pattern=rms_norm found=5 applied=5 "
                 "missed=0 kernel_nodes=0 expected=5 [ok]",
                 "model=plain_llama pattern=rope found=4 applied=4 "
                 "missed=0 kernel_nodes=0 expected=4 [ok]"):
        assert line in out
    assert "fusion audit: pass" in out


def test_fusion_audit_fails_on_lost_coverage(capsys, monkeypatch):
    fa = _load_audit()
    # the GPT judged by the Llama's floors: no norm, SwiGLU or RoPE site
    monkeypatch.setitem(fa.MODELS, "gpt", (fa.MODELS["gpt"][0], "llama"))
    rc = fa.main(["--models", "gpt"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "NOT-FOUND" in out and "FAIL" in out
