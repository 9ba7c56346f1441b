"""Train the shape detectors of ``weights/detect*.npz`` on the CUDA card.

The port of the JAX package's ``tools/train_detect3.py``, option for
option: the same seed plans, dataset cache, recipe, augmentations,
held-out evaluation and outputs, so a run here reproduces or extends a
committed checkpoint (``weights/detect80_full.json`` records how the
served one was made: ``--arch full --classes 80 --jpeg-q 90 --batch 16
--steps 3500``).

Seed plans (disjoint by construction): 3 classes train 1000+, validation
20000+, test 30000+; 9 classes 100000+ / 120000+ / 130000+; 80 classes
200000+ / 220000+ / 230000+ (the test seeds are the gates', never
trained on).

- **Recipe:** ``clip_by_global_norm(10)``, then AdamW (decay 5e-4 on the
  conv kernels) under ``warmup_cosine_decay_schedule(0, lr, warmup =
  min(100, max(1, steps // 10)), decay_steps = max(steps, warmup + 1),
  end = 0.05 lr)`` (parallel/train.py); weights from ``--init-from`` or
  ``synthetic_params(seed=42)``.
- **Resident dataset:** the uint8 scenes and their targets go to the
  device once; each step ships index, flip and jitter vectors drawn from
  ``numpy.random.RandomState(7)`` in the JAX tool's order. Targets are
  slot rows flipped on the device (``--sparse-targets``, automatic at 80
  classes) or the four flip variants prebuilt densely (float16 for the
  full arch), gathered at ``flip * N + idx``.
- **Augmentation** (:func:`augment`): gather and /255, per-image
  horizontal / vertical flips, colour jitter (per channel; shared across
  channels at 80 classes, where hue is half the class), sensor noise of
  sigma 0.02 from a ``torch.Generator`` on the device, a clip to [0, 1].
- **Held-out evaluation** every ``--eval-every`` steps and at the end:
  the folded bf16 ``YoloNet`` and ``postprocess_batch`` at threshold 0.3
  in ``--eval-chunk`` slices, then ``to_reference_results`` and
  ``synth.match_detections``; frames with every object matched
  (localize), and those with no false positive as well (strict).
- **Outputs:** the best-strict parameters as a float16 ``.npz`` (early
  stop at ``--target-strict``) and a ``.json`` sidecar with the JAX
  tool's keys and the evaluation history.

Differences from the JAX tool: the noise is torch's stream, not
``jax.random``'s; the dataset cache lives under the temporary directory
(``tempfile.gettempdir()``). ``main(argv, device=...)`` takes another
device (the tests pass ``"cpu"``) and returns a report of the run.

Usage: python -m fastdet_tpu_torch.tools.train_detect [--steps 3000]
           [--batch 16] [--n-train 384] [--n-val 64] [--classes 80]
           [--arch full] [--jpeg-q 90] [--out weights/detect80_full.npz]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

EVAL_THR = 0.3
NOISE_SIGMA = 0.02
SEED_PLANS = {3: (1000, 20000), 9: (100000, 120000), 80: (200000, 220000)}


def load_or_make(split: str, seeds, cache_dir=None, num_classes: int = 3,
                 jpeg_q: int = 0, max_objects: int = 3):
    """Generate (or load cached) scenes and their boxes and labels for a
    seed range; the JAX tool's cache key. ``jpeg_q`` > 0 round-trips each
    scene through JPEG at that quality (serving traffic is JPEG); the
    boxes describe the same objects."""
    from fastdet_tpu_torch.data import synth

    if cache_dir is None:
        cache_dir = os.path.join(tempfile.gettempdir(), "fastdet_shapes")
    os.makedirs(cache_dir, exist_ok=True)
    tag = "" if num_classes == 3 else f":c{num_classes}"
    if jpeg_q:
        tag += f":q{jpeg_q}"
    if max_objects != 3:
        tag += f":m{max_objects}"
    key = hashlib.sha1(
        ("v1" + tag + ":" + split + ":" + ",".join(map(str, seeds))).encode()
    ).hexdigest()[:16]
    path = os.path.join(cache_dir, f"{split}_{key}.npz")
    if os.path.exists(path):
        with np.load(path, allow_pickle=True) as z:
            return z["imgs"], list(z["boxes"]), list(z["labels"])
    t0 = time.time()
    imgs, boxes, labels = synth.make_dataset(
        seeds, num_classes=num_classes, max_objects=max_objects)
    if jpeg_q:
        from fastdet_tpu_torch.runtime import jpeg as jpeg_mod

        imgs = np.stack([
            jpeg_mod.decode_rgb(jpeg_mod.encode_rgb(im, quality=jpeg_q))
            for im in imgs])
    tmp = path + ".tmp.npz"
    np.savez(tmp, imgs=imgs, boxes=np.asarray(boxes, dtype=object),
             labels=np.asarray(labels, dtype=object))
    os.replace(tmp, path)
    print(f"[data] {split}: {len(seeds)} scenes in {time.time()-t0:.1f}s")
    return imgs, boxes, labels


def evaluate(res, boxes, labels, size):
    """(localize, strict, false positives per frame) of a batched
    NMSResult of host arrays against the frames' ground truth."""
    from fastdet_tpu_torch.data import synth
    from fastdet_tpu_torch.ops.postprocess import to_reference_results

    loc_ok = strict_ok = 0
    total_fp = 0
    n = len(boxes)
    for i in range(n):
        one = type(res)(*[a[i] for a in res])
        dets = to_reference_results(one, size)
        m, t, fp = synth.match_detections(dets, boxes[i], labels[i], size)
        loc_ok += m == t
        strict_ok += (m == t) and fp == 0
        total_fp += fp
    return loc_ok / n, strict_ok / n, total_fp / n


def held_out(spec, params, val, boxes, labels, chunk: int):
    """(localize, strict, false positives per frame) of the unfolded
    parameter tree ``params`` on the held-out scenes ``val`` (uint8
    (N, H, W, 3) on the device) and their ground truth: the folded bf16
    ``YoloNet`` and ``postprocess_batch`` at ``EVAL_THR`` in ``chunk``
    slices, then :func:`evaluate`."""
    import torch

    from fastdet_tpu_torch.models import weights as weights_io
    from fastdet_tpu_torch.models import yolov3
    from fastdet_tpu_torch.ops.postprocess import postprocess_batch

    net = yolov3.YoloNet(spec, weights_io.fold_params(spec, params),
                         dtype=torch.bfloat16, device=val.device)
    outs = []
    with torch.no_grad():
        for lo in range(0, val.shape[0], chunk):
            x = val[lo:lo + chunk].to(torch.float32) / 255.0
            res = postprocess_batch(net(x), spec, EVAL_THR)
            outs.append([a.cpu().numpy() for a in res])
    res = type(res)(*[np.concatenate(cols) for cols in zip(*outs)])
    return evaluate(res, boxes, labels, spec.image_size)


def dense_flip_targets(spec, boxes, labels, store):
    """The four flip variants' dense targets of every scene (bit 0 a
    horizontal flip, bit 1 a vertical one), per scale flattened to
    (4 * N, g, g, 3, 5 + C) at index flip * N + i, in ``store``'s dtype."""
    from fastdet_tpu_torch.parallel import train as train_lib

    variants = []
    for f in range(4):
        boxes_f = []
        for b in boxes:
            b = b.copy()
            if f & 1:
                b[:, 0] = 1.0 - b[:, 0]
            if f & 2:
                b[:, 1] = 1.0 - b[:, 1]
            boxes_f.append(b)
        variants.append(train_lib.build_targets(spec, boxes_f, labels))
    return [np.concatenate([v[s] for v in variants]).astype(store)
            for s in range(spec.num_outputs)]


def augment(data, targets, idx, flip, cj_scale, cj_off, noise, grids,
            sparse: bool):
    """One step's batch from the resident set: ``data`` (N, H, W, 3)
    uint8, ``targets`` (slot rows,) or the flattened flip-variant dense
    targets, ``idx`` / ``flip`` (B,) integer tensors, ``cj_scale`` /
    ``cj_off`` (B, 3) float32, ``noise`` (B, H, W, 3) standard normal ->
    (images in [0, 1], the targets of the flipped scenes): the JAX tool's
    step before its train step."""
    import torch

    from fastdet_tpu_torch.parallel import train as train_lib

    imgs = data[idx].to(torch.float32) / 255.0
    fh = (flip & 1).to(torch.bool)
    fv = ((flip >> 1) & 1).to(torch.bool)
    imgs = torch.where(fh[:, None, None, None], imgs.flip(2), imgs)
    imgs = torch.where(fv[:, None, None, None], imgs.flip(1), imgs)
    imgs = imgs * cj_scale[:, None, None, :] + cj_off[:, None, None, :]
    imgs = imgs + noise * NOISE_SIGMA
    imgs = torch.clamp(imgs, 0.0, 1.0)
    if sparse:
        picked = (train_lib.flip_slots(targets[0][idx], fh, fv, grids),)
    else:
        fi = flip * data.shape[0] + idx
        picked = tuple(t[fi].to(torch.float32) for t in targets)
    return imgs, picked


def draw_step(rng, n, batch, classes):
    """One step's (idx, flip, jitter scale, jitter offset) from ``rng`` in
    the JAX tool's order and shapes."""
    idx = rng.randint(n, size=batch).astype(np.int32)
    flip = rng.randint(4, size=batch).astype(np.int32)
    if classes == 80:
        # hue is half the class identity in the 80-class world: jitter
        # brightness and contrast only, shared across channels
        cj_s = np.repeat(rng.uniform(0.8, 1.2, (batch, 1)),
                         3, 1).astype(np.float32)
        cj_o = np.repeat(rng.uniform(-0.10, 0.10, (batch, 1)),
                         3, 1).astype(np.float32)
    else:
        cj_s = rng.uniform(0.75, 1.25, (batch, 3)).astype(np.float32)
        cj_o = rng.uniform(-0.12, 0.12, (batch, 3)).astype(np.float32)
    return idx, flip, cj_s, cj_o


def _parse(argv):
    ap = argparse.ArgumentParser(prog=argv[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n-train", type=int, default=384)
    ap.add_argument("--n-val", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--target-strict", type=float, default=0.97,
                    help="early-stop when held-out strict success passes this")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"),
                    help="train compute dtype")
    ap.add_argument("--classes", type=int, default=3, choices=(3, 9, 80),
                    help="shape classes: 3 (disc/box/tri), the 9-class "
                         "palette, or the 80-class hue-x-shape palette")
    ap.add_argument("--arch", default="tiny", choices=("tiny", "full"),
                    help="tiny (2-scale) or the Darknet-53 full (3-scale)")
    ap.add_argument("--eval-chunk", type=int, default=32,
                    help="eval forward batch size")
    ap.add_argument("--init-from", default=None,
                    help="fine-tune from an existing .npz checkpoint "
                         "instead of random init")
    ap.add_argument("--max-objects", type=int, default=3,
                    help="objects per scene cap")
    ap.add_argument("--sparse-targets", action="store_true",
                    help="slot-row targets + on-device flips (automatic "
                         "for --classes 80)")
    ap.add_argument("--jpeg-q", type=int, default=0,
                    help="round-trip train/val scenes through JPEG at "
                         "this quality (0 = raw pixels)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv[1:])
    if args.out is None:
        args.out = f"weights/detect{args.classes}_{args.arch}.npz"
    return args


def main(argv, device="cuda"):
    """Train as the module docstring says, on ``device`` (the card by
    default; raises without one). Returns the report of the run: the
    sidecar's fields under "meta", and the warm steps' ms, the lr at the
    first and last step, the gradient norms before the clip at the first
    and last step and their maximum."""
    args = _parse(argv)

    import torch

    from fastdet_tpu_torch import device as device_mod
    from fastdet_tpu_torch.data import synth
    from fastdet_tpu_torch.models import weights as weights_io
    from fastdet_tpu_torch.models import yolov3
    from fastdet_tpu_torch.parallel import train as train_lib

    dev = device_mod.resolve(device)
    print("[env] device:", torch.cuda.get_device_name(dev)
          if dev.type == "cuda" else dev)
    spec = yolov3.get_spec(args.arch, args.classes)
    tr_base, va_base = SEED_PLANS[args.classes]
    tr_imgs, tr_boxes, tr_labels = load_or_make(
        "train", range(tr_base, tr_base + args.n_train),
        num_classes=args.classes, jpeg_q=args.jpeg_q,
        max_objects=args.max_objects)
    va_imgs, va_boxes, va_labels = load_or_make(
        "val", range(va_base, va_base + args.n_val),
        num_classes=args.classes, jpeg_q=args.jpeg_q,
        max_objects=args.max_objects)

    t0 = time.time()
    use_sparse = args.classes == 80 or args.sparse_targets
    grids = yolov3.head_grid_sizes(spec)
    if use_sparse:
        tgts = [train_lib.build_sparse_targets(spec, tr_boxes, tr_labels)]
        print(f"[data] sparse targets built in {time.time()-t0:.1f}s "
              f"shape={tgts[0].shape}")
    else:
        # offsets and log-ratios are O(1): float16's rounding is far
        # under the loss's resolution, and halves the full arch's store
        store = np.float16 if args.arch == "full" else np.float32
        tgts = dense_flip_targets(spec, tr_boxes, tr_labels, store)
        print(f"[data] flip-variant targets built in {time.time()-t0:.1f}s "
              f"shapes={[t.shape for t in tgts]} store={store.__name__}")

    t0 = time.time()
    data = torch.from_numpy(tr_imgs).to(dev)
    dev_tgts = tuple(torch.from_numpy(t).to(dev) for t in tgts)
    val = torch.from_numpy(va_imgs).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"[h2d] dataset resident in {time.time()-t0:.1f}s")

    warmup = min(100, max(1, args.steps // 10))
    sched = train_lib.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=warmup,
        decay_steps=max(args.steps, warmup + 1), end_value=args.lr * 0.05)
    if args.init_from:
        spec_ck, params = weights_io.load_npz(args.init_from)
        if (spec_ck.name, spec_ck.num_classes) != (spec.name,
                                                   spec.num_classes):
            raise SystemExit(f"checkpoint arch mismatch: {args.init_from} "
                             f"is {spec_ck.name}:{spec_ck.num_classes}")
        print(f"[init] resumed from {args.init_from}")
    else:
        params = weights_io.synthetic_params(spec, seed=42)
    state = train_lib.init_train_state(spec, params, lr=sched,
                                       clip_norm=10.0, device=dev)
    step = train_lib.make_train_step(
        spec, compute_dtype=torch.bfloat16 if args.dtype == "bf16" else None,
        sparse=use_sparse)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.RandomState(7)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    t_start = time.time()
    best = (-1.0, -1.0)
    history = []
    norms = []
    warm_s, warm_steps, t_warm = 0.0, 0, None
    for s in range(1, args.steps + 1):
        idx, flip, cj_s, cj_o = (torch.from_numpy(a).to(dev) for a in
                                 draw_step(rng, len(tr_imgs), args.batch,
                                           args.classes))
        noise = torch.randn(
            (args.batch,) + tuple(data.shape[1:]), generator=gen, device=dev)
        imgs, picked = augment(data, dev_tgts, idx.long(), flip.long(),
                               cj_s, cj_o, noise, grids, use_sparse)
        state, metrics = step(state, imgs, *picked)
        norms.append(metrics["grad_norm"])
        if s == 1:   # the warm steps start after the first
            sync()
            t_warm = time.time()
        else:
            warm_steps += 1
        if s % 50 == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[step {s:5d}] loss={m['loss']:9.3f} "
                  f"coord={m['coord']:8.3f} obj={m['obj']:8.3f} "
                  f"cls={m['cls']:7.3f} "
                  f"({(time.time()-t_start)/s*1e3:.0f} ms/step)")
        if s % args.eval_every == 0 or s == args.steps:
            sync()
            if t_warm is not None and s > 1:
                warm_s += time.time() - t_warm
            loc, strict, fp = held_out(spec, state.net.to_params(), val,
                                       va_boxes, va_labels, args.eval_chunk)
            print(f"[eval {s:5d}] held-out: localize={loc:.3f} "
                  f"strict={strict:.3f} fp/frame={fp:.2f}")
            history.append({"step": s, "localize": loc,
                            "strict": strict, "fp_per_frame": fp})
            if (strict, loc) > best:
                best = (strict, loc)
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                weights_io.save_npz(args.out, spec, state.net.to_params(),
                                    dtype=np.float16)
                print(f"[ckpt] saved {args.out} "
                      f"({os.path.getsize(args.out)/1e6:.1f} MB)")
            if strict >= args.target_strict:
                print(f"[done] target reached at step {s}")
                break
            sync()
            t_warm = time.time()

    meta = {
        "arch": args.arch, "num_classes": args.classes,
        "classes": list({3: synth.SHAPE_CLASSES,
                         9: synth.SHAPE_CLASSES_9,
                         80: synth.SHAPE_CLASSES_80}[args.classes]),
        "max_objects": args.max_objects,
        "jpeg_q": args.jpeg_q,
        "train_seeds": [tr_base, tr_base + args.n_train],
        "val_seeds": [va_base, va_base + args.n_val],
        "steps_run": history[-1]["step"] if history else 0,
        "batch": args.batch,
        "final_eval": history[-1] if history else None,
        "best_strict": best[0], "best_localize": best[1],
        "history": history,
        "wall_s": round(time.time() - t_start, 1),
    }
    with open(os.path.splitext(args.out)[0] + ".json", "w") as fp:
        json.dump(meta, fp, indent=1)
    print(f"[meta] {json.dumps(meta['final_eval'])}")
    print(f"[total] {time.time()-t_start:.0f}s")
    norms = [float(v) for v in norms]
    return {
        "meta": meta,
        "warm_ms_per_step": (1e3 * warm_s / warm_steps if warm_steps
                             else None),
        "warm_steps": warm_steps,
        "lr_first": sched(0), "lr_last": sched(len(norms) - 1),
        "grad_norm_first": norms[0], "grad_norm_last": norms[-1],
        "grad_norm_max": max(norms),
    }


if __name__ == "__main__":
    main(sys.argv)
