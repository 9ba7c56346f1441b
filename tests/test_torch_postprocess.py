"""The port's postprocess (decode -> top-K budget -> soft-NMS -> wire
records) against the JAX package's select_batch / soft_nms_batch /
pack_wire_records on the same head tensors, tied scores included
(lax.top_k is stable; the port uses a stable descending sort).

Classes, pick order, validity, counts and the wire bytes are identical.
The float fields are not bit for bit: torch.sigmoid and torch.exp differ
from XLA's logistic and exp by up to 2 ulp on the CPU, so scores differ
by a few ulp and box corners (x - w/2, a cancellation) by a few ulp of
the box size; they are held to rtol 1e-5."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fastdet_tpu.models import yolov3 as jax_yolov3
from fastdet_tpu.ops import nms as jax_nms
from fastdet_tpu.ops import postprocess as jax_pp
from fastdet_tpu_torch.models import yolov3
from fastdet_tpu_torch.ops import nms, postprocess


def _heads(seed, spec, b=3, ties=False):
    rng = np.random.RandomState(seed)
    grids = yolov3.head_grid_sizes(spec)
    heads = [(rng.randn(b, g, g, spec.head_channels) * 2.0).astype(np.float32)
             for g in grids]
    if ties:
        # whole cells repeated: identical scores at different positions,
        # so candidate order among equals decides the picks
        h = heads[0]
        h[:, 1:, :, :] = h[:, :1, :, :]
        h[:, :, 1:, :] = h[:, :, :1, :]
    return heads


def _run_both(heads, spec, jspec, thr, max_det=100):
    th = [torch.from_numpy(h) for h in heads]
    t_thr = torch.from_numpy(thr)
    sb, ss, sk = postprocess.select_batch(th, spec, t_thr)
    res = nms.soft_nms_batch(sb, ss, sk, t_thr, max_det)
    wire = postprocess.pack_wire_records(res, spec.image_size).numpy()
    jh = [jnp.asarray(h) for h in heads]
    jsb, jss, jsk = jax_pp.select_batch(jh, jspec, jnp.asarray(thr))
    jres = jax_nms.soft_nms_batch(jsb, jss, jsk, jnp.asarray(thr), max_det)
    jwire = np.asarray(jax_pp.pack_wire_records(jres, jspec.image_size))
    return (sb, ss, sk, res, wire), (jsb, jss, jsk, jres, jwire)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True)])
def test_postprocess_bitexact(seed, ties):
    spec = yolov3.get_spec("tiny", 80)
    jspec = jax_yolov3.get_spec("tiny", 80)
    heads = _heads(seed, spec, ties=ties)
    thr = np.array([0.3, 0.5, 0.7], np.float32)
    (sb, ss, sk, res, wire), (jsb, jss, jsk, jres, jwire) = _run_both(
        heads, spec, jspec, thr)
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jsk))
    np.testing.assert_array_equal(res.klass.numpy(), np.asarray(jres.klass))
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(jres.valid))
    np.testing.assert_array_equal(res.count.numpy(), np.asarray(jres.count))
    np.testing.assert_array_equal(wire, jwire)
    for a, b in ((sb, jsb), (ss, jss), (res.boxes, jres.boxes),
                 (res.scores, jres.scores)):
        w = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    assert res.count.min() > 0


@pytest.mark.parametrize("arch", ["tiny", "full"])
def test_head_anchors_made_once_decode_as_jax(arch):
    """The anchors are made once per (anchors, device) and reused by
    every forward (nothing uploaded from the host inside a CUDA graph);
    the decode with them equals the one with anchors made per call bit
    for bit, and the JAX package's decode as the test above holds it."""
    from fastdet_tpu.ops import decode as jax_decode
    from fastdet_tpu_torch.ops import decode

    spec = yolov3.get_spec(arch, 80)
    jspec = jax_yolov3.get_spec(arch, 80)
    cpu = torch.device("cpu")
    anchors = decode.head_anchors(spec, cpu)
    assert decode.head_anchors(spec, cpu) is anchors
    assert [a.tolist() for a in anchors] == [
        [list(p) for p in a] for a in spec.anchors]
    heads = _heads(3, spec, b=1)
    th = [torch.from_numpy(h) for h in heads]
    comps, scores, klass = decode.decode_all_components(th, spec)
    per_call = [decode.decode_head_components(
        h, torch.tensor(a, dtype=torch.float32), spec.num_classes,
        spec.image_size) for h, a in zip(th, spec.anchors)]
    for i in range(4):
        torch.testing.assert_close(
            comps[i], torch.cat([c[0][i] for c in per_call], 1),
            rtol=0, atol=0)
    torch.testing.assert_close(scores, torch.cat([c[1] for c in per_call],
                                                 1), rtol=0, atol=0)
    jcomps, jscores, jklass = jax_decode.decode_all_components(
        [jnp.asarray(h[0]) for h in heads], jspec)
    np.testing.assert_array_equal(klass[0].numpy(), np.asarray(jklass))
    for a, b in zip(comps + (scores,), jcomps + (jscores,)):
        w = np.asarray(b)
        np.testing.assert_allclose(a[0].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_tied_scores_keep_candidate_order():
    """Equal scores keep ascending candidate order (a stable top-K)."""
    from fastdet_tpu_torch.ops import decode

    scores = torch.tensor([[0.5, 0.75, 0.5, 0.75, 0.125, 0.5]])
    comps = tuple(torch.arange(6, dtype=torch.float32)[None] + i
                  for i in range(4))
    klass = torch.arange(1, 7, dtype=torch.int32)[None]
    boxes, top, k = decode.select_candidates_components(
        comps, scores, klass, torch.tensor([0.2]), 4)
    assert k[0].tolist() == [2, 4, 1, 3]
    assert boxes[0, :, 0].tolist() == [1.0, 3.0, 0.0, 2.0]
    assert top[0].tolist() == [0.75, 0.75, 0.5, 0.5]


def test_soft_nms_early_exit_equals_full_trip_count():
    """The loop stops once no image can make a valid pick; its output
    equals the JAX package's fixed-trip vmap(soft_nms)."""
    from jax import vmap

    rng = np.random.RandomState(4)
    b, k = 2, 64
    boxes = rng.rand(b, k, 4).astype(np.float32) * 0.5
    scores = rng.rand(b, k).astype(np.float32)
    klass = rng.randint(1, 81, (b, k)).astype(np.int32)
    thr = np.array([0.2, 0.9], np.float32)
    scores = np.where(scores >= thr[:, None], scores, -1.0).astype(np.float32)
    res = nms.soft_nms_batch(*(torch.from_numpy(a) for a in
                               (boxes, scores, klass, thr)), 100)
    full = vmap(lambda bb, s, kk, t: jax_nms.soft_nms(bb, s, kk, t, 100))(
        boxes, scores, klass, thr)
    for a, w in zip(res, full):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def test_wire_packing_saturates_like_jax():
    boxes = np.array([[[1e6, -1e6, np.nan, 0.5], [0.1, 0.2, 0.3, 0.4]]],
                     np.float32)
    scores = np.array([[np.nan, 2.0]], np.float32)
    klass = np.array([[3, 7]], np.int32)
    valid = np.array([[True, True]])
    count = np.array([2], np.int32)
    ours = postprocess.pack_wire_records(nms.NMSResult(
        *(torch.from_numpy(a) for a in (boxes, scores, klass, valid, count))),
        416).numpy()
    theirs = np.asarray(jax_pp.pack_wire_records(jax_nms.NMSResult(
        *(jnp.asarray(a) for a in (boxes, scores, klass, valid, count))), 416))
    np.testing.assert_array_equal(ours, theirs)
