"""The port's data-parallel train step on the CPU: two gloo ranks against
the one-process step and the JAX package's sharded step.

Two spawned processes (a FileStore under tmp_path, no port) each take
their rows of one global batch of 4 (parallel/train.shard_batch) and run
one make_sharded_train_step on a tiny spec (64 px, 4 classes, synthetic
weights from one seed, as tests/test_torch_train.py). Their step must be
the global-batch step: equal to the one-process port step at batch 4 and
to the JAX ``make_sharded_train_step`` over ``make_mesh(cpu_devices[:2],
dp=2, tp=1)``, at tests/test_torch_train.py's tolerances:

- loss (the ranks' mean): rtol 1e-5;
- parameters after the step: within 1e-6 wherever |g| is at least 1e-3
  of its tensor's max, within 2·lr + 1e-6 elsewhere (the first Adam step
  moves a parameter by about lr·sign(g));
- BN running statistics: rtol 1e-5, atol 1e-7;
- Adam moments: the first within 1e-4 of its tensor's max (the
  gradients' bound), the second within 2e-4 (it squares them).

Both ranks must hold the same state bit for bit. A step with per-rank BN
(each rank's statistics from its own rows) is shown to differ by far
more than these tolerances, so the test tells the two apart. Each
spawned process is joined with a timeout: a hang fails the test.

This module imports no JAX at its top: the spawned ranks import it.
"""

import numpy as np
import pytest
import torch

from fastdet_tpu_torch.models import weights, yolov3
from fastdet_tpu_torch.parallel import train

LR = 1e-3
WORLD = 2
JOIN_S = 120


def _small_spec(mod, num_classes=4, image_size=64):
    s = mod.yolov3_tiny_spec(num_classes)
    return mod.ModelSpec(s.name, s.num_classes, s.layers, s.anchors,
                         image_size=image_size)


SPEC = _small_spec(yolov3)

BOXES = [np.array([[0.3, 0.3, 0.4, 0.4], [0.7, 0.6, 0.2, 0.3]], np.float32),
         np.array([[0.5, 0.5, 0.6, 0.5]], np.float32),
         np.zeros((0, 4), np.float32),
         np.array([[0.2, 0.7, 0.3, 0.2]], np.float32)]
LABELS = [np.array([0, 3]), np.array([2]), np.zeros((0,), np.int32),
          np.array([1])]


def _batch():
    images = np.random.RandomState(3).rand(4, 64, 64, 3).astype(np.float32)
    return images, train.build_targets(SPEC, BOXES, LABELS)


def _state():
    return train.init_train_state(SPEC, weights.synthetic_params(SPEC, 5),
                                  lr=LR, device="cpu")


def _dump(state, metrics):
    """{loss, params (the unfolded tree), moments {param name: (m, v)}}."""
    names = {id(p): n for n, p in state.net.named_parameters()}
    moments = {names[id(p)]: (s["exp_avg"].numpy().copy(),
                              s["exp_avg_sq"].numpy().copy())
               for p, s in state.optimizer.state.items()}
    return {"loss": float(metrics["loss"]), "params": state.net.to_params(),
            "moments": moments}


def _rank_main(rank, store, out):
    """One gloo rank: its rows of the global batch, one sharded step."""
    import pickle

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        images, targets = train.shard_batch(None, *_batch())
        step = train.make_sharded_train_step(SPEC)
        state, metrics = step(_state(), torch.from_numpy(images),
                              *[torch.from_numpy(t) for t in targets])
        with open(out, "wb") as fp:
            pickle.dump(_dump(state, metrics), fp)
    finally:
        dist.destroy_process_group()


def _spawn(target, args_of, n):
    """Run ``target(*args_of(k))`` in ``n`` spawned processes, each joined
    with a timeout."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(k)) for k in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
            assert not p.is_alive(), f"{p.name} did not end in {JOIN_S} s"
            assert p.exitcode == 0, f"{p.name} exit code {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' dumps after one sharded step."""
    import pickle

    tmp = tmp_path_factory.mktemp("dp")
    store = str(tmp / "store")
    outs = [str(tmp / f"rank{k}.pkl") for k in range(WORLD)]
    _spawn(_rank_main, lambda k: (k, store, outs[k]), WORLD)
    dumps = []
    for o in outs:
        with open(o, "rb") as fp:
            dumps.append(pickle.load(fp))
    return dumps


@pytest.fixture(scope="module")
def one_process():
    """The one-process port step at batch 4: its dump and gradients."""
    images, targets = _batch()
    state, metrics = train.make_train_step(SPEC)(
        _state(), torch.from_numpy(images),
        *[torch.from_numpy(t) for t in targets])
    grads = {n: p.grad.numpy().copy() for n, p in
             state.net.named_parameters()}
    return _dump(state, metrics), grads


def _leaves(tree):
    for name, p in tree.items():
        for k, v in p.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    yield name, kk, vv
            else:
                yield name, k, v


def _grad_of(grads, name, leaf):
    g = grads[f"convs.{name}.{leaf}"]
    return g.transpose(2, 3, 1, 0) if leaf == "w" else g


def _assert_step_close(got_params, want_params, grads):
    want = {(n, k): v for n, k, v in _leaves(want_params)}
    n = 0
    for name, leaf, got in _leaves(got_params):
        w = np.asarray(want[(name, leaf)])
        key = f"{name}/{leaf}"
        if leaf in ("mean", "var"):
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-7,
                                       err_msg=key)
        else:
            g = _grad_of(grads, name, leaf)
            clear = np.abs(g) >= 1e-3 * np.abs(g).max()
            diff = np.abs(got - w)
            assert diff[clear].max() <= 1e-6, key
            assert diff.max() <= 2 * LR + 1e-6, key
        n += 1
    assert n == len(want)


def test_ranks_hold_one_state(ranks):
    """DDP averages the gradients and every rank computes the same BN
    EMA: the two ranks' states are equal bit for bit."""
    a, b = ranks
    for (_, _, x), (_, _, y) in zip(_leaves(a["params"]),
                                    _leaves(b["params"])):
        np.testing.assert_array_equal(x, y)
    for k in a["moments"]:
        for x, y in zip(a["moments"][k], b["moments"][k]):
            np.testing.assert_array_equal(x, y)


def test_two_rank_step_matches_one_process_step(ranks, one_process):
    want, grads = one_process
    loss = np.mean([r["loss"] for r in ranks])
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-5)
    _assert_step_close(ranks[0]["params"], want["params"], grads)
    assert ranks[0]["moments"].keys() == want["moments"].keys()
    for k, (m, v) in ranks[0]["moments"].items():
        wm, wv = want["moments"][k]
        assert np.abs(m - wm).max() <= 1e-4 * np.abs(wm).max(), k
        assert np.abs(v - wv).max() <= 2e-4 * np.abs(wv).max(), k


def test_two_rank_step_matches_jax_sharded_step(ranks, one_process,
                                                cpu_devices):
    """The JAX global-batch step over a dp=2 mesh of two virtual CPU
    devices, from the same parameters on the same batch."""
    import jax
    import jax.numpy as jnp

    from fastdet_tpu.models import weights as jax_weights
    from fastdet_tpu.models import yolov3 as jax_yolov3
    from fastdet_tpu.parallel import mesh as jax_mesh
    from fastdet_tpu.parallel import train as jax_train

    jspec = _small_spec(jax_yolov3)
    params = jax.tree_util.tree_map(
        jnp.asarray, jax_weights.synthetic_params(jspec, 5))
    mesh = jax_mesh.make_mesh(cpu_devices[:2], dp=2, tp=1)
    step, state = jax_train.make_sharded_train_step(
        jspec, mesh, jax_train.make_optimizer(LR), params)
    images, targets = _batch()
    img, tgt = jax_train.shard_batch(mesh, images, targets)
    state, metrics = step(state, img, *tgt)
    _, grads = one_process
    loss = np.mean([r["loss"] for r in ranks])
    np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-5)
    _assert_step_close(ranks[0]["params"],
                       jax.tree_util.tree_map(np.asarray, state.params),
                       grads)


def test_per_rank_bn_would_differ(ranks, one_process):
    """Rank 0's rows alone through the one-process step (BN from its own
    two rows, what a plain DDP step would do) move the loss and the BN
    running statistics far outside the tolerances above."""
    images, targets = _batch()
    state, metrics = train.make_train_step(SPEC)(
        _state(), torch.from_numpy(images[:2]),
        *[torch.from_numpy(t[:2]) for t in targets])
    local = _dump(state, metrics)
    assert abs(local["loss"] - ranks[0]["loss"]) > 1e-3 * abs(
        ranks[0]["loss"])
    worst = 0.0
    for (name, leaf, x), (_, _, y) in zip(_leaves(local["params"]),
                                          _leaves(ranks[0]["params"])):
        if leaf in ("mean", "var"):
            worst = max(worst, float((np.abs(x - y)
                                      / (1e-7 + 1e-5 * np.abs(y))).max()))
    assert worst > 100.0


def _cli(argv, world_size):
    from fastdet_tpu_torch.cli import train as train_cli

    assert train_cli.main(argv, device="cpu", world_size=world_size) == 0


def test_cli_train_two_ranks_writes_the_one_rank_export(tmp_path):
    """cli.train with world_size=2 (two gloo ranks of the default mesh,
    dp = 1 x tp = 2: tests/test_torch_train_tp.py's layout; the dp-only
    step is this module's rank tests') exports what the one-process run
    exports: one step at batch 4, the BN running statistics at rtol 1e-5, every other
    value within 2·lr + 1e-6 (a near-zero gradient may take either sign)
    and all but 1 % of them within 1e-6."""
    outs = {}
    for world in (1, 2):
        out = str(tmp_path / f"w{world}.npz")
        argv = ["train", "--synthetic", "-a", "tiny", "-c", "4",
                "--image-size", "64", "--steps", "1", "--batch", "4",
                "--log-every", "1", "-o", out]
        if world == 1:
            _cli(argv, 1)
        else:   # the CLI spawns the ranks: run it in a joined process
            _spawn(_cli, lambda k: (argv, world), 1)
        outs[world] = np.load(out)
    a, b = outs[1], outs[2]
    assert sorted(a.files) == sorted(b.files)
    close = total = 0
    for k in a.files:
        x, y = a[k], b[k]
        if k.endswith(("mean", "var")):
            np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
            continue
        d = np.abs(x - y)
        assert d.max() <= 2 * 1e-3 + 1e-6, k
        close += int((d <= 1e-6).sum())
        total += d.size
    assert close >= 0.99 * total, (close, total)
