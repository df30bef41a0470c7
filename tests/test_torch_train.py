"""The port's training path against the JAX package's.

Every case makes its inputs with numpy from a seed and hands the same
arrays to both sides:

- the fused linear cross-entropy (``nn.functional.fused_linear_cross_entropy``)
  against the JAX op's custom_vjp (``_fused_linear_ce``): the loss and both
  gradients, with a vocabulary of 300 in chunks of 128 (three chunks, the
  last padded), labels at -100, and both weight layouts; and against the
  port's own unfused ``cross_entropy`` on the logits;
- Adam/AdamW (``paddle_tpu_torch.optimizer``) against the JAX optimizers
  over several eager steps on the same parameters and gradients: float32
  with decoupled decay, ``apply_decay_param_fun``, ``lr_ratio``, amsgrad
  and ``ClipGradByGlobalNorm``; bfloat16 with ``multi_precision`` (float32
  masters) and without (float32 moments all the same); ``state_dict`` keys
  and a round trip;
- a tiny Llama (hidden 64, 2 layers, 4 heads, 2 KV heads, vocab 128) with
  the JAX weights bridged, batch 2 x 16: the first loss and the first
  backward's gradients, then 5 steps of ``compile_train_step(model,
  lambda m, i, l: m(i, labels=l), AdamW(1e-3))`` on both sides, in float32
  and in bfloat16 with ``multi_precision``;
- serving a trainable model leaves no KV pool in an autograd graph.

Tolerances, each with its reason:

- loss and gradients in float32: atol 1e-5 on the loss, 2e-5 absolute plus
  1e-4 relative on gradients (the same float32 products summed in other
  orders by the two BLAS libraries and the flash/XLA attention
  formulations, through 2 layers);
- optimizer state in float32: rtol 1e-6, atol 1e-9 (the same elementwise
  operations in the same order; the last bit may differ where a library
  fuses a multiply-add);
- Llama parameters after 5 AdamW steps: AdamW's first step is close to
  lr * sign(g), so where a gradient is within float rounding of 0 the two
  sides may step 2 * lr apart. No element may differ by more than
  2 * lr * 5 = 1e-2, and at most 1% of the elements by more than 1e-5;
- losses over the 5 float32 steps: atol 1e-4 (the loss moves by ~0.1 a
  step, so a sign flip of a few near-zero gradients moves it by far less);
- bfloat16 Llama: losses within 0.0625 (the loss itself is bfloat16, whose
  spacing at 4-8 is 0.03125: two ulps for the two sides' different
  rounding points over 5 steps), and the loss must fall.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.impl.fused import _fused_linear_ce

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.jit import compile_train_step
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as F

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4


def _f32(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ----------------------------------------------------------------------
# fused linear cross-entropy
# ----------------------------------------------------------------------

@pytest.mark.parametrize("transpose_w", [False, True], ids=["hv", "vh_tied"])
def test_fused_linear_cross_entropy_matches_jax(transpose_w):
    rng = np.random.default_rng(0)
    t, h, v = 24, 16, 300                      # chunks of 128: 3, last padded
    hid = _f32(rng, (t, h))
    w = _f32(rng, (v, h) if transpose_w else (h, v), 0.5)
    lab = rng.integers(0, v, t).astype(np.int32)
    lab[[2, 7, 19]] = -100
    chunk = 128

    loss_j, vjp = jax.vjp(lambda a, b: _fused_linear_ce(
        a, b, jnp.asarray(lab), transpose_w, chunk), jnp.asarray(hid),
        jnp.asarray(w))
    dh_j, dw_j = vjp(jnp.ones((), jnp.float32))

    th = torch.from_numpy(hid).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = F.fused_linear_cross_entropy(th, tw, torch.from_numpy(lab),
                                        transpose_weight=transpose_w,
                                        chunk_size=chunk)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=1e-5)
    for got, want in ((th.grad, dh_j), (tw.grad, dw_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # ignored rows get no gradient at all
    assert float(th.grad[[2, 7, 19]].abs().max()) == 0.0

    # the unfused route: logits, then cross_entropy with ignore_index -100
    th2 = torch.from_numpy(hid).requires_grad_()
    tw2 = torch.from_numpy(w).requires_grad_()
    logits = th2 @ (tw2.t() if transpose_w else tw2)
    ref = F.cross_entropy(logits, torch.from_numpy(lab).long())
    ref.backward()
    np.testing.assert_allclose(loss.item(), ref.item(), atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), th2.grad.numpy(),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
    np.testing.assert_allclose(tw.grad.numpy(), tw2.grad.numpy(),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_fused_linear_cross_entropy_chunk_and_dtype():
    """The chunk is min(chunk_size, V rounded up to 128); a bfloat16
    hidden gives a bfloat16 loss and gradients in the inputs' types; no
    valid label gives a loss of 0 and zero gradients."""
    rng = np.random.default_rng(1)
    hid = torch.from_numpy(_f32(rng, (2, 5, 8))).bfloat16().requires_grad_()
    w = torch.from_numpy(_f32(rng, (8, 200))).bfloat16().requires_grad_()
    lab = torch.from_numpy(rng.integers(0, 200, (2, 5)))
    loss = F.fused_linear_cross_entropy(hid, w, lab)      # chunk 256 > V
    loss.backward()
    assert loss.dtype == torch.bfloat16
    assert hid.grad.dtype == torch.bfloat16 and hid.grad.shape == hid.shape
    assert w.grad.dtype == torch.bfloat16
    want = F.cross_entropy((hid.float() @ w.float()).reshape(-1, 200),
                           lab.reshape(-1))
    assert abs(loss.item() - want.item()) <= 0.0625   # two bf16 ulps at 4-8
    hid.grad = None
    none = F.fused_linear_cross_entropy(hid, w, torch.full((2, 5), -100))
    none.backward()
    assert none.item() == 0.0 and float(hid.grad.abs().max()) == 0.0


# ----------------------------------------------------------------------
# optimizers
# ----------------------------------------------------------------------

SHAPES = [(6, 5), (5,), (3, 4)]


def _param_pair(arrays, dtype, names=None):
    """The same values as JAX Parameters and torch Parameters."""
    names = names or [""] * len(arrays)
    jps, tps = [], []
    for a, n in zip(arrays, names):
        jps.append(JaxParameter(jnp.asarray(a, dtype=jnp.dtype(dtype)),
                                name=n or None))
        tp = torch.nn.Parameter(torch.from_numpy(a).to(getattr(torch, dtype)))
        if n:
            tp.param_name = n     # a torch tensor's own name is read-only
        tps.append(tp)
    return jps, tps


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(getattr(x, "_value", x)).astype(np.float32)


def _run_pair(make, dtype, steps=4, names=None, seed=0, grad_scale=1.0):
    rng = np.random.default_rng(seed)
    arrays = [_f32(rng, s) for s in SHAPES]
    jps, tps = _param_pair(arrays, dtype, names)
    jo = make(jopt, jps)
    to = make(topt, tps)
    for _ in range(steps):
        for jp, tp, s in zip(jps, tps, SHAPES):
            g = _f32(rng, s, grad_scale)
            jp.grad = paddle.to_tensor(g).astype(dtype)
            tp.grad = torch.from_numpy(g).to(tp.dtype)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        assert all(tp.grad is None for tp in tps)
    return jps, tps, jo, to


def _state_close(jo, to, jps, tps):
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert list(jsd) == list(tsd)
    for k, v in jsd.items():
        if k == "@step":
            assert tsd[k] == v
            continue
        np.testing.assert_allclose(_as_np(tsd[k]), _as_np(v), rtol=1e-6,
                                   atol=1e-9, err_msg=k)


_GLOBAL_NORM = {jopt: jclip.ClipGradByGlobalNorm,
                topt: topt.ClipGradByGlobalNorm}

OPT_CASES = {
    "adamw": lambda m, ps: m.AdamW(0.01, parameters=ps, weight_decay=0.05),
    "adamw_amsgrad": lambda m, ps: m.AdamW(0.01, parameters=ps,
                                           amsgrad=True),
    "adam_l2": lambda m, ps: m.Adam(0.01, parameters=ps, weight_decay=0.1),
    "adamw_clip": lambda m, ps: m.AdamW(
        0.01, parameters=ps, grad_clip=_GLOBAL_NORM[m](0.5)),
    "adamw_groups": lambda m, ps: m.AdamW(
        0.01, parameters=[{"params": ps[:1], "learning_rate": 0.5},
                          {"params": ps[1:], "weight_decay": 0.2}]),
    "adamw_lr_ratio": lambda m, ps: m.AdamW(
        0.01, parameters=ps, lr_ratio=lambda p: 0.5 if p.ndim == 1 else 1.0),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adam_float32_matches_jax(case):
    jps, tps, jo, to = _run_pair(OPT_CASES[case], "float32",
                                 grad_scale=3.0 if "clip" in case else 1.0)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(),
                                   rtol=1e-6, atol=1e-9)
    _state_close(jo, to, jps, tps)


def test_adamw_apply_decay_param_fun_matches_jax():
    """Parameters named "*.bias" are exempt from the decoupled decay; with
    zero gradients the others shrink by (1 - lr * wd) a step and the
    exempt one stays."""
    names = ["w0", "l.bias", "w2"]
    make = lambda m, ps: m.AdamW(  # noqa: E731
        0.1, parameters=ps, weight_decay=0.5,
        apply_decay_param_fun=lambda n: not n.endswith("bias"))
    jps, tps, jo, to = _run_pair(make, "float32", names=names, grad_scale=0.0)
    rng = np.random.default_rng(0)          # _run_pair's starting values
    start = [_f32(rng, s) for s in SHAPES]
    for jp, tp, a, n in zip(jps, tps, start, names):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(),
                                   rtol=1e-6)
        want = a if n.endswith("bias") else a * (1 - 0.1 * 0.5) ** 4
        np.testing.assert_allclose(tp.detach().numpy(), want, rtol=1e-5)
    assert list(to.state_dict())[:2] == ["w0.moment1", "w0.moment2"]


@pytest.mark.parametrize("multi_precision", [True, False],
                         ids=["masters", "no_masters"])
def test_adamw_bfloat16_matches_jax(multi_precision):
    """bf16 parameters: float32 masters under multi_precision, float32
    moments either way; parameters stay bf16. Masters and moments rtol
    1e-6; bf16 parameters within one bf16 ulp (a float32 value within
    rounding of a bf16 tie may round either way)."""
    make = lambda m, ps: m.AdamW(  # noqa: E731
        1e-3, parameters=ps, multi_precision=multi_precision)
    jps, tps, jo, to = _run_pair(make, "bfloat16")
    for jp, tp in zip(jps, tps):
        assert tp.dtype == torch.bfloat16
        want = _as_np(jp)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(_as_np(tp) - want) <= ulp)
    sd = to.state_dict()
    for i, tp in enumerate(tps):
        assert sd[f"param_{i}.moment1"].dtype == torch.float32
        assert sd[f"param_{i}.beta2_pow"].dtype == torch.float32
        assert (f"param_{i}.master_weight" in sd) == multi_precision
        if multi_precision:
            assert sd[f"param_{i}.master_weight"].dtype == torch.float32
    _state_close(jo, to, jps, tps)


def test_optimizer_state_dict_round_trip():
    """A fresh optimizer loaded from state_dict continues exactly where
    the first one is; saved state is copied, not shared."""
    rng = np.random.default_rng(3)
    arrays = [_f32(rng, s) for s in SHAPES]
    _, a = _param_pair(arrays, "bfloat16")
    _, b = _param_pair(arrays, "bfloat16")
    oa = topt.AdamW(1e-2, parameters=a, multi_precision=True)
    grads = [[_f32(rng, s) for s in SHAPES] for _ in range(3)]
    for g in grads[:2]:
        for p, gg in zip(a, g):
            p.grad = torch.from_numpy(gg).bfloat16()
        oa.step()
        oa.clear_grad()
    with torch.no_grad():
        for pb, pa in zip(b, a):
            pb.copy_(pa)
    ob = topt.AdamW(1e-2, parameters=b, multi_precision=True)
    ob.set_state_dict(oa.state_dict())
    assert ob.state_dict()["@step"] == 2
    assert ob.state_dict()["param_0.moment1"] is not \
        oa.state_dict()["param_0.moment1"]
    for opt, ps in ((oa, a), (ob, b)):
        for p, gg in zip(ps, grads[2]):
            p.grad = torch.from_numpy(gg).bfloat16()
        opt.step()
    for pa, pb in zip(a, b):
        assert torch.equal(pa, pb)
    for k, v in oa.state_dict().items():
        if k != "@step":
            assert torch.equal(v, ob.state_dict()[k]), k


def test_optimizer_refuses_later_slices():
    """A scheduler drives the rate as in JAX; parameters are required; the
    compiler's options still raise, each naming what it needs; and
    LlamaConfig(recompute=True) builds a model that computes what the
    recompute=False one does (the flag alone changes nothing in JAX)."""
    p = [torch.nn.Parameter(torch.ones(2))]
    to = topt.AdamW(topt.lr.StepDecay(0.1, step_size=2), parameters=p)
    jo = jopt.AdamW(jopt.lr.StepDecay(0.1, step_size=2),
                    parameters=[JaxParameter(jnp.ones(2))])
    for _ in range(5):
        assert to.get_lr() == jo.get_lr()
        to._lr_scheduler.step()
        jo._lr_scheduler.step()
    with pytest.raises(RuntimeError, match="LRScheduler"):
        to.set_lr(0.5)
    with pytest.raises(ValueError, match="parameters"):
        topt.AdamW(0.1)
    model = torch.nn.Linear(2, 2)
    with pytest.raises(NotImplementedError, match="compiler slice"):
        compile_train_step(model, lambda m, x: m(x).sum(),
                           topt.AdamW(0.1, parameters=model.parameters()),
                           fuse=True)
    with pytest.raises(NotImplementedError, match="compiler slice"):
        compile_train_step(model, lambda m, x: m(x).sum(),
                           topt.AdamW(0.1, parameters=model.parameters()),
                           remat_policy="fused")
    with pytest.raises(NotImplementedError, match="apply_llama_remat"):
        compile_train_step(model, lambda m, x: m(x).sum(),
                           topt.AdamW(0.1, parameters=model.parameters()),
                           remat_policy=jax.checkpoint_policies.nothing_saveable)
    cfg = LlamaConfig.tiny()
    cfg.recompute = True
    jcfg = JaxLlamaConfig.tiny()
    jcfg.recompute = True
    paddle.seed(0)
    jm = JaxLlama(jcfg)
    tm = weights.from_paddle_tpu_state(
        {n: np.asarray(q._value) for n, q in jm.named_parameters()},
        LlamaForCausalLM(cfg, device="cpu"))
    assert tm.config.recompute
    ids, lab = _batch(cfg.vocab_size)
    want = float(jm(paddle.to_tensor(ids), labels=paddle.to_tensor(lab)))
    got = tm(torch.from_numpy(ids), labels=torch.from_numpy(lab)).item()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_optimizer_options_not_taken_raise():
    """lazy_mode=True (Adam, AdamW) and auto_skip_clip=True are taken and
    give the JAX package's results: the dense rule, and the global-norm
    clip. A float weight_decay stays a decoupled coefficient in AdamW and
    becomes L2Decay in Adam."""
    cases = {
        "adam_lazy": lambda m, ps: m.Adam(0.01, parameters=ps,
                                          lazy_mode=True),
        "adamw_lazy": lambda m, ps: m.AdamW(0.01, parameters=ps,
                                            lazy_mode=True),
        "clip_auto_skip": lambda m, ps: m.AdamW(
            0.01, parameters=ps,
            grad_clip=_GLOBAL_NORM[m](0.5, auto_skip_clip=True)),
    }
    for name, make in cases.items():
        jps, tps, jo, to = _run_pair(make, "float32",
                                     grad_scale=3.0 if "clip" in name
                                     else 1.0)
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=name)
        _state_close(jo, to, jps, tps)
    p = [torch.nn.Parameter(torch.ones(2))]
    assert topt.AdamW(0.1, parameters=p, weight_decay=0.05)._weight_decay \
        == 0.05
    wd = topt.Adam(0.1, parameters=p, weight_decay=0.05)._weight_decay
    assert isinstance(wd, topt.L2Decay) and wd.coeff == 0.05


# ----------------------------------------------------------------------
# Llama training
# ----------------------------------------------------------------------

BATCH, SEQ, STEPS, LR = 2, 16, 5, 1e-3


def _batch(vocab):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    lab = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    lab[0, :3] = -100                       # a few ignored positions
    return ids, lab


def _jax_model(dtype):
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())
    if dtype == "bfloat16":
        jm.bfloat16()
    return jm


def _port_model(jm, dtype):
    arrays = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                          dtype=getattr(torch, dtype))
    return weights.from_paddle_tpu_state(arrays, tm)


def _train(step, ids, lab, to_tensor):
    return [float(_as_np(step(to_tensor(ids), to_tensor(lab))))
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def f32_runs():
    """The float32 pair: first loss and gradients (eager backward), then
    5 compile_train_step steps on each side, and the port's eager loop on
    a third model."""
    jm = _jax_model("float32")
    tm = _port_model(jm, "float32")
    tm_eager = _port_model(jm, "float32")
    ids, lab = _batch(tm.config.vocab_size)
    jl = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(lab))
    jl.backward()
    j_grads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    jm.clear_gradients()
    tl = tm(torch.from_numpy(ids), labels=torch.from_numpy(lab))
    tl.backward()
    t_grads = {n: p.grad.numpy().copy() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)

    loss_fn = lambda m, i, l: m(i, labels=l)  # noqa: E731
    jstep = jjit.compile_train_step(
        jm, loss_fn, jopt.AdamW(LR, parameters=jm.parameters()))
    j_losses = _train(jstep, ids, lab, paddle.to_tensor)
    topt_ = topt.AdamW(LR, parameters=tm.parameters())
    t_losses = _train(compile_train_step(tm, loss_fn, topt_), ids, lab,
                      torch.from_numpy)
    eo = topt.AdamW(LR, parameters=tm_eager.parameters())
    e_losses = []
    for _ in range(STEPS):
        loss = tm_eager(torch.from_numpy(ids), labels=torch.from_numpy(lab))
        loss.backward()
        eo.step()
        eo.clear_grad()
        e_losses.append(loss.item())
    return {"jl": float(jl.numpy()), "tl": tl.item(), "j_grads": j_grads,
            "t_grads": t_grads, "j_losses": j_losses, "t_losses": t_losses,
            "e_losses": e_losses, "jm": jm, "tm": tm, "tm_eager": tm_eager}


def test_llama_loss_and_grads_match_jax(f32_runs):
    r = f32_runs
    np.testing.assert_allclose(r["tl"], r["jl"], atol=1e-5)
    assert sorted(r["t_grads"]) == sorted(r["j_grads"])
    for n, want in r["j_grads"].items():
        np.testing.assert_allclose(r["t_grads"][n], want, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=n)


def test_llama_train_steps_match_jax(f32_runs):
    """5 AdamW steps of compile_train_step: losses, and parameters under
    the sign-flip bound of AdamW's first steps."""
    r = f32_runs
    np.testing.assert_allclose(r["t_losses"], r["j_losses"], atol=1e-4)
    assert r["t_losses"][-1] < r["t_losses"][0]
    jp = dict(r["jm"].named_parameters())
    n_far = n_all = 0
    for n, p in r["tm"].named_parameters():
        diff = np.abs(p.detach().numpy() - np.asarray(jp[n]._value))
        assert diff.max() <= 2 * LR * STEPS, n
        n_far += int((diff > 1e-5).sum())
        n_all += diff.size
    assert n_far <= 0.01 * n_all, (n_far, n_all)


def test_llama_eager_loop_equals_compile_train_step(f32_runs):
    """The eager loss.backward / step / clear_grad loop and
    compile_train_step compute the same thing, bit for bit, on the CPU."""
    r = f32_runs
    assert r["e_losses"] == r["t_losses"]
    for (n, a), (_, b) in zip(r["tm"].named_parameters(),
                              r["tm_eager"].named_parameters()):
        assert torch.equal(a, b), n


def test_llama_bfloat16_multi_precision_tracks_jax():
    jm = _jax_model("bfloat16")
    tm = _port_model(jm, "bfloat16")
    ids, lab = _batch(tm.config.vocab_size)
    loss_fn = lambda m, i, l: m(i, labels=l)  # noqa: E731
    jstep = jjit.compile_train_step(
        jm, loss_fn, jopt.AdamW(LR, parameters=jm.parameters(),
                                multi_precision=True))
    j_losses = _train(jstep, ids, lab, paddle.to_tensor)
    to = topt.AdamW(LR, parameters=tm.parameters(), multi_precision=True)
    t_losses = _train(compile_train_step(tm, loss_fn, to), ids, lab,
                      torch.from_numpy)
    np.testing.assert_allclose(t_losses, j_losses, atol=0.0625)
    assert t_losses[-1] < t_losses[0]
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    masters = [v for k, v in to.state_dict().items()
               if k.endswith(".master_weight")]
    assert len(masters) == len(list(tm.parameters()))
    assert all(m.dtype == torch.float32 for m in masters)


def test_serving_a_trainable_model_builds_no_graph(f32_runs):
    """Trouble spot of trainable parameters: the engine writes K/V into
    its pools in place; under inference mode no pool joins a graph, and
    training after serving still works."""
    tm = f32_runs["tm_eager"]
    assert all(p.requires_grad for p in tm.parameters())
    prompts = [np.array([3, 1, 4, 1, 5, 9, 2], np.int32),
               np.array([2, 7, 1, 8], np.int32)]
    out = tm.generate_batch(prompts, max_new_tokens=4, max_slots=2,
                            page_size=4, max_seq_len=32)
    assert [len(o) for o in out] == [11, 8]
    eng = tm.get_engine(max_slots=2, page_size=4, max_seq_len=32)
    pools = eng.k_pages + eng.v_pages
    assert not any(t.requires_grad or t.grad_fn is not None for t in pools)
    eng.add_request(prompts[0], max_new_tokens=2)     # step() outside any
    while eng.has_work():                               # inference_mode
        eng.step()
    assert not any(t.requires_grad for t in eng.k_pages + eng.v_pages)
    ids, lab = _batch(tm.config.vocab_size)
    loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(lab))
    loss.backward()
    assert all(p.grad is not None for p in tm.parameters())
    tm.zero_grad(set_to_none=True)
