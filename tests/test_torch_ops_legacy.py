"""The port's detection and legacy ops (``ops/impl/detection.py``,
``misc_legacy.py``, ``sampling_legacy.py``) against the JAX package's, on
the CPU: every case of ``tests/test_detection_legacy_ops.py`` runs
through both packages.

- ``ops_sweep_torch.LEGACY`` holds one case of each of the 42 ops, built
  from those tests' inputs: outputs equal JAX's in shape, dtype and value
  (float32 1e-5 relative, integers exact), and for the marked ones the
  gradients of a random weighting of the outputs equal JAX's tape;
- then each test of that file is repeated on the port with its own
  assertions, beside the JAX op's result where the two are
  deterministic. The random ops draw from numpy Generators seeded the
  same way in both packages (an op's ``seed``), so ``shuffle_batch`` and
  ``tdm_sampler`` give JAX's draws; the weighted neighbour sampler is held
  by its property, as in the JAX test. ``TransformedDistribution``
  (the file's last test) belongs to ``distribution``, which the port
  does not have yet.
- The host ops return their outputs on their input's device.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as ptt
from torch_parity import (SWEEP, call_both, case_id, check,  # noqa: F401
                          check_grad, cpu_device, to_np)

torch.set_num_threads(1)

CASES = SWEEP.LEGACY.CASES


def test_the_table_covers_every_legacy_op():
    from paddle_tpu.ops.registry import OP_TABLE as JT
    mods = {"paddle_tpu.ops.impl.detection",
            "paddle_tpu.ops.impl.misc_legacy",
            "paddle_tpu.ops.impl.sampling_legacy"}
    names = {n for n, e in JT.items() if e["fn"].__module__ in mods}
    assert len(names) == 42
    assert names == {c[0] for c in CASES}
    assert all(hasattr(ptt, n) for n in names)


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_legacy_op_matches_jax(case):
    name, args, kwargs, opts = case
    check(name, args, kwargs, tol=opts.get("tol"))


GRAD_CASES = [c for c in CASES if c[3].get("grad")]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[case_id(c) for c in GRAD_CASES])
def test_legacy_op_grad_matches_jax(case):
    name, args, kwargs, opts = case
    check_grad(name, args, kwargs, tol=(2e-5, 2e-6), diff=opts.get("diff"))


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _j(a):
    return paddle.to_tensor(np.asarray(a))


# -- the JAX file's tests, on the port --------------------------------------

def test_yolo_box_threshold_and_decode_value():
    x = np.random.default_rng(0).standard_normal((2, 27, 4, 4)).astype(
        np.float32)
    img = np.asarray([[128, 128], [96, 64]], np.int32)
    boxes, scores = ptt.yolo_box(_t(x), _t(img), anchors=[10, 13, 16, 30,
                                                          33, 23],
                                 class_num=4, conf_thresh=0.5)
    assert boxes.shape == (2, 48, 4) and scores.shape == (2, 48, 4)
    dead = scores.numpy().max(-1) == 0
    assert (boxes.numpy()[dead] == 0).all()
    raw = np.zeros((1, 6, 1, 1), np.float32)
    raw[0, 4] = raw[0, 5] = 10.0
    args = (raw, np.asarray([[64, 64]], np.int32))
    kw = {"anchors": [16, 16], "class_num": 1, "conf_thresh": 0.01,
          "downsample_ratio": 32, "clip_bbox": False}
    b, _ = ptt.yolo_box(*map(_t, args), **kw)
    np.testing.assert_allclose(b.numpy()[0, 0], [16, 16, 48, 48], rtol=1e-5)
    got, want = call_both("yolo_box", args, kw)
    np.testing.assert_allclose(to_np(got[0]), to_np(want[0]), rtol=1e-6)


def test_yolo_loss_matches_and_grads():
    x = _t(np.random.default_rng(1).standard_normal((2, 27, 4, 4)).astype(
        np.float32)).requires_grad_(True)
    gt = _t(np.asarray([[[0.5, 0.5, 0.3, 0.4], [0, 0, 0, 0]]] * 2,
                       np.float32))
    gl = _t(np.asarray([[1, 0]] * 2, np.int32))
    loss, obj, match = ptt.yolo_loss(x, gt, gl, anchors=[10, 13, 16, 30, 33,
                                                         23],
                                     anchor_mask=[0, 1, 2], class_num=4,
                                     downsample_ratio=32)
    assert loss.shape == (2,)
    m = match.numpy()
    assert (m[:, 1] == -1).all() and (m[:, 0] >= 0).all()
    loss.sum().backward()
    g = x.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0


def test_matrix_nms_suppresses_duplicates():
    bb = np.asarray([[[0, 0, 10, 10], [0.2, 0.2, 10.2, 10.2],
                      [20, 20, 30, 30]]], np.float32)
    sc = np.zeros((1, 2, 3), np.float32)
    sc[0, 1] = [0.9, 0.85, 0.8]
    out, idx, num = ptt.matrix_nms(_t(bb), _t(sc), score_threshold=0.1,
                                   nms_top_k=10, keep_top_k=10,
                                   post_threshold=0.5, return_index=True)
    o = out.numpy()
    assert int(num.numpy()[0]) == o.shape[0] == 2
    np.testing.assert_allclose(sorted(o[:, 1].tolist(), reverse=True)[0],
                               0.9)


def test_bipartite_match_and_box_clip():
    mi, md = ptt.bipartite_match(_t(np.asarray(
        [[0.9, 0.1], [0.3, 0.8], [0.2, 0.2]], np.float32)))
    assert mi.numpy().tolist() == [0, 1]
    np.testing.assert_allclose(md.numpy(), [0.9, 0.8], rtol=1e-6)
    out = ptt.box_clip(_t(np.asarray([[[-1, -1, 9, 9]]], np.float32)),
                       _t(np.asarray([[8, 8, 1.0]], np.float32)))
    assert out.numpy().reshape(-1).tolist() == [0, 0, 7, 7]


def test_psroi_pool_position_sensitive():
    x = np.zeros((1, 8, 4, 4), np.float32)
    for c in range(8):
        x[0, c] = c
    out = ptt.psroi_pool(_t(x), _t(np.asarray([[0, 0, 3, 3]], np.float32)),
                         _t(np.asarray([1], np.int32)), 2, 2, 2, 1.0)
    np.testing.assert_allclose(out.numpy()[0], np.arange(
        8, dtype=np.float32).reshape(2, 2, 2))


def test_generate_proposals_and_fpn_routing():
    case = {c[0]: c for c in CASES}
    _, args, kw, _ = case["generate_proposals"]
    rois, probs, nums = ptt.generate_proposals(*map(_t, args), **kw)
    r = rois.numpy()
    assert r.shape[1] == 4 and r.shape[0] == int(nums.numpy()[0])
    assert (r[:, 2] >= r[:, 0]).all() and (r[:, 3] >= r[:, 1]).all()
    assert (np.diff(probs.numpy().reshape(-1)) <= 1e-6).all()
    multi, restore = ptt.distribute_fpn_proposals(
        _t(np.asarray([[0, 0, 10, 10], [0, 0, 500, 500]], np.float32)),
        2, 5, 4, 224)
    assert [m.shape[0] for m in multi] == [1, 0, 0, 1]
    assert sorted(restore.numpy().tolist()) == [0, 1]
    jm, jr = paddle.distribute_fpn_proposals(
        _j(np.asarray([[0, 0, 10, 10], [0, 0, 500, 500]], np.float32)),
        2, 5, 4, 224)
    for a, b in zip(multi, jm):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(restore.numpy(), jr.numpy())


def test_detection_map_perfect_and_half():
    gt = _t(np.asarray([[1, 0, 0, 10, 10, 0]], np.float32))
    det = _t(np.asarray([[1, 0.9, 0, 0, 10, 10]], np.float32))
    assert float(ptt.detection_map(det, gt)) == pytest.approx(1.0)
    det2 = _t(np.asarray([[1, 0.9, 0, 0, 10, 10], [1, 0.8, 50, 50, 60, 60]],
                         np.float32))
    assert 0.5 <= float(ptt.detection_map(det2, gt)) <= 1.0


def test_crf_decoding_padded_batch_and_label():
    r = np.random.default_rng(0)
    em = r.normal(size=(2, 4, 3)).astype(np.float32)
    tr = r.normal(size=(5, 3)).astype(np.float32)
    lens = np.asarray([4, 2], np.int64)
    got, want = call_both("crf_decoding", (em, tr), {"length": lens})
    np.testing.assert_array_equal(to_np(got), to_np(want))
    lab = to_np(want).copy()
    lab[0, 1] = (lab[0, 1] + 1) % 3
    got, want = call_both("crf_decoding", (em, tr), {"length": lens,
                                                      "label": lab})
    np.testing.assert_array_equal(to_np(got), to_np(want))


def test_channel_and_sequence_ops_values():
    x = torch.arange(0, 2 * 8 * 2 * 2, dtype=torch.float32).reshape(2, 8, 2,
                                                                   2)
    z = ptt.shuffle_channel(ptt.shuffle_channel(x, group=2), group=4)
    assert torch.equal(z, x)
    out = ptt.affine_channel(torch.ones(1, 3, 2, 2), _t([1., 2., 3.]),
                             _t([0., 1., 2.]))
    np.testing.assert_allclose(out.numpy()[0, :, 0, 0], [1, 3, 5])
    a = _t(np.arange(12).reshape(2, 6).astype(np.float32))
    assert ptt.partial_concat([a, a * 10], start_index=1,
                              length=2).tolist() == [[1, 2, 10, 20],
                                                     [7, 8, 70, 80]]
    assert ptt.partial_sum([a, a * 10], start_index=1,
                           length=2).tolist() == [[11, 22], [77, 88]]
    assert ptt.im2sequence(torch.randn(2, 3, 8, 8), kernels=[2, 2],
                           strides=[2, 2]).shape == (32, 12)
    pe = ptt.add_position_encoding(torch.zeros(1, 4, 6), alpha=0.0,
                                   beta=1.0)[0]
    np.testing.assert_allclose(pe[0].numpy(), [0, 0, 0, 1, 1, 1], atol=1e-6)
    cv = ptt.cvm(_t(np.asarray([[1.0, 3.0, 5.0, 6.0]], np.float32)), None)
    np.testing.assert_allclose(cv.numpy()[0, :2],
                               [np.log(2.0), np.log(4.0) - np.log(2.0)],
                               rtol=1e-6)
    x = _t(np.arange(8, dtype=np.float32).reshape(4, 2))
    lod = _t(np.asarray([0, 1, 4], np.int64))
    np.testing.assert_allclose(ptt.sequence_pool(x, lod, "AVERAGE").numpy(),
                               [[0, 1], [4, 5]])
    mx, idx = ptt.sequence_pool(x, lod, "MAX")
    assert idx.tolist() == [[0, 0], [3, 3]] and mx.tolist() == [[0, 1],
                                                               [6, 7]]
    f = np.zeros((6, 2), np.float32)
    f[2, 0] = f[3, 1] = 1.0
    np.testing.assert_allclose(ptt.sequence_conv(x, lod, _t(f),
                                                 context_length=3).numpy(),
                               x.numpy())
    for pool in ("SUM", "SQRT", "LAST", "FIRST"):
        got, want = call_both("sequence_pool", (x.numpy(), lod.numpy(),
                                                pool))
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6)


def test_lookup_table_dequant_and_rank_attention_values():
    w = np.zeros((3, 4), np.float32)
    w[:, 1] = 1.0
    w[1, 2:] = np.frombuffer(np.arange(8, dtype=np.uint8).tobytes(),
                             np.float32)
    out = ptt.lookup_table_dequant(_t(w), _t(np.asarray([[1]], np.int64)))
    np.testing.assert_allclose(out.numpy().reshape(-1), np.arange(8) / 256.0,
                               rtol=1e-6)
    ih, out, _ = ptt.rank_attention(
        _t(np.asarray([[1., 2.], [3., 4.]], np.float32)),
        _t(np.asarray([[1, 1, 0, 0, -1], [0, 0, -1, 0, -1]], np.int32)),
        _t(np.arange(8, dtype=np.float32).reshape(8, 1)), max_rank=2)
    np.testing.assert_allclose(ih.numpy()[0], [1, 2, 0, 0])
    assert (ih.numpy()[1] == 0).all()
    np.testing.assert_allclose(out.numpy()[0], [2.0])


def test_sampling_ops_draws_and_properties():
    x = _t(np.arange(10, dtype=np.float32).reshape(5, 2))
    out, idx, _ = ptt.shuffle_batch(x, seed=_t(np.asarray([7], np.int64)))
    assert sorted(idx.tolist()) == list(range(5))
    np.testing.assert_allclose(out.numpy(), x.numpy()[idx.numpy()])
    _, jidx, _ = paddle.shuffle_batch(
        _j(x.numpy()), seed=_j(np.asarray([7], np.int64)))
    np.testing.assert_array_equal(idx.numpy(), jidx.numpy())
    colptr = _t(np.asarray([0, 2, 3, 5, 5], np.int64))
    row = _t(np.asarray([1, 2, 0, 1, 3], np.int64))
    nodes = _t(np.asarray([0, 2], np.int64))
    ew = _t(np.asarray([1., 1., 1., 1e-9, 1e9], np.float32))
    ptt.seed(3)
    o2, _ = ptt.weighted_sample_neighbors(row, colptr, ew, nodes,
                                          sample_size=1)
    assert int(o2[1]) == 3
    src, dst, nodes_out, _ = ptt.graph_khop_sampler(row, colptr, nodes,
                                                    sample_sizes=[2])
    no = nodes_out.numpy()
    assert no[0] == 0 and no[1] == 2
    assert (src.numpy() < len(no)).all() and (dst.numpy() < len(no)).all()
    o, lab, _ = ptt.tdm_sampler(
        _t(np.asarray([[0], [1]], np.int32)),
        _t(np.asarray([[1, 2], [1, 3]], np.int32)),
        _t(np.asarray([1, 2, 3], np.int32)), output_positive=True,
        neg_samples_num_list=[0, 1], layer_offset_lod=[0, 1, 3], seed=7)
    assert o.shape == (2, 3) and (lab.numpy()[:, :2] == 1).all()
    assert int(o[0, 2]) == 3 and int(o[1, 2]) == 2
    u, v = torch.zeros(10), torch.zeros(10)
    g = torch.arange(1.0, 11.0)
    _, _, eg, go, _, _ = ptt.dgc(u, v, g, sparsity=[0.7],
                                 current_step=_t(np.asarray([10.0],
                                                            np.float32)))
    assert set(torch.nonzero(eg).reshape(-1).tolist()) == {7, 8, 9}
    assert int((go != 0).sum()) == 7
    out, olod = ptt.pyramid_hash(_t(np.asarray([3, 7, 9, 2], np.int64)),
                                 torch.randn(50, 16),
                                 _t(np.asarray([0, 4], np.int64)),
                                 num_emb=16, space_len=49, pyramid_layer=3,
                                 rand_len=16)
    assert out.shape == (5, 16) and olod.tolist() == [0, 5]


def test_chunk_eval_schemes_match_jax():
    r = np.random.default_rng(5)
    for scheme, types, arity in (("IOB", 2, 2), ("IOE", 2, 2),
                                 ("IOBES", 2, 4), ("plain", 3, 1)):
        inf = r.integers(0, types * arity + 1, 30).astype(np.int64)
        lab = r.integers(0, types * arity + 1, 30).astype(np.int64)
        got, want = call_both("chunk_eval", (inf, lab),
                              {"num_chunk_types": types,
                               "chunk_scheme": scheme})
        for a, b in zip(to_np(got), to_np(want)):
            np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("name", sorted({c[0] for c in CASES}))
def test_legacy_op_signature_matches_jax(name):
    import inspect

    def params(fn):
        return [(p.name, p.default, p.kind) for p in inspect.signature(
            inspect.unwrap(fn)).parameters.values()]
    assert params(getattr(ptt, name)) == params(getattr(paddle, name))
