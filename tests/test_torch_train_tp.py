"""The port's ('dp', 'tp') layout and its channel-sharded train step on the
CPU, against the one-process step and the JAX package's sharded step.

The layout: ``make_mesh``'s degrees against the JAX ``make_mesh`` (the
default tp = 2 on an even count above 1, pinned dp, pinned tp), the
sharded conv set against the JAX ``param_shardings`` and a rank's
``shard_params`` slice against the JAX shard on the matching device.

The step: spawned gloo ranks on a FileStore (each joined with a
timeout, one thread each) lay a mesh of dp = 1 x tp = 2 (two ranks) or
dp = 2 x tp = 2 (four ranks) over themselves, take their dp index's rows
of one global batch of 4 (tests/test_torch_train_dp.py's tiny 64-px
spec, batch and weights) and run one make_sharded_train_step; the state
after it, gathered over tp, is held against the one-process port step and
the JAX ``make_sharded_train_step`` over ``make_mesh(cpu_devices[:2],
dp=1, tp=2)`` / ``make_mesh(cpu_devices[:4], dp=2, tp=2)`` at
test_torch_train_dp.py's tolerances:

- loss (the dp ranks' mean): rtol 1e-5;
- parameters after the step: within 1e-6 wherever |g| is at least 1e-3
  of its tensor's max, within 2·lr + 1e-6 elsewhere;
- BN running statistics: rtol 1e-5, atol 1e-7;
- Adam moments: the first within 1e-4 of its tensor's max, the second
  within 2e-4.

Every rank holds the same gathered state bit for bit; BN reduced over the
whole world instead of the dp group (channels of different tp shards
summed together) differs by far more than the tolerances; the gathered
export loads with the JAX ``load_model``; a checkpoint written from the
shards restores into them; the global gradient norm of the clip counts a
sharded conv's squares once. ``cli.train(world_size=2)`` and
``(world_size=4)`` lay dp = 1 and 2 x tp = 2 by default and export what
the one-rank run exports.

This module imports no JAX at its top: the spawned ranks import it.
"""

import numpy as np
import pytest
import torch

from fastdet_tpu_torch.models import weights, yolov3
from fastdet_tpu_torch.parallel import mesh, train

LR = 1e-3
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


def _dump(state, metrics):
    """{loss, params (the full unfolded tree), moments {param name: (m,
    v)} over every channel, grad_norm}: collective over tp."""
    named = {id(p): n for n, p in state.net.named_parameters()}
    moments = {}
    for p, s in state.optimizer.state.items():
        name = named[id(p)]
        conv = name.split(".")[1]
        moments[name] = tuple(state.net.full(conv, s[k]).numpy().copy()
                              for k in ("exp_avg", "exp_avg_sq"))
    # the step leaves each .grad in place: the clip's norm of them
    norm = train.clip_by_global_norm(state.net, float("inf"))
    return {"loss": float(metrics["loss"]), "params": state.net.to_params(),
            "moments": moments, "grad_norm": float(norm)}


def _rank_main(rank, world, dp, store, out, bn_world):
    """One gloo rank of a dp x 2 mesh: its dp index's rows, one sharded
    step, the gathered dump; rank 0 also exports, and every rank saves a
    checkpoint and restores it into a fresh sharded state."""
    import os
    import pickle

    import torch.distributed as dist

    from fastdet_tpu_torch.parallel import checkpoint

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        groups = mesh.process_groups(
            mesh.make_mesh(["cpu"] * world, dp=dp, tp=2))
        images, targets = train.shard_batch(groups.dp_group, *_batch())
        state = train.init_train_state(
            SPEC, weights.synthetic_params(SPEC, 5), lr=LR, device="cpu",
            groups=groups)
        if bn_world:   # BN over every rank: the fault the dp group avoids
            state.net.bn_group = None
        step = train.make_sharded_train_step(SPEC, groups=groups)
        state, metrics = step(state, torch.from_numpy(images),
                              *[torch.from_numpy(t) for t in targets])
        dump = _dump(state, metrics)
        dump["shards"] = [tuple(c.w.shape) for c in state.net.convs.values()]
        if not bn_world:
            base = os.path.dirname(out)
            checkpoint.export_inference(os.path.join(base, "export.npz"),
                                        SPEC, state)
            ck = os.path.join(base, "state.pt")
            checkpoint.save(ck, state)
            dist.barrier()
            fresh = checkpoint.restore(ck, train.init_train_state(
                SPEC, weights.synthetic_params(SPEC, 1), lr=LR,
                device="cpu", groups=groups))
            a, b = state.net.state_dict(), fresh.net.state_dict()
            opt_a = state.optimizer.state_dict()["state"]
            opt_b = fresh.optimizer.state_dict()["state"]
            dump["restored_equal"] = (
                fresh.step == state.step
                and all(torch.equal(a[k], b[k]) for k in a)
                and all(torch.equal(opt_a[i][k], opt_b[i][k])
                        for i in opt_a for k in opt_a[i]))
        with open(out, "wb") as fp:
            pickle.dump(dump, fp)
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


def _run_ranks(tmp, dp, bn_world=False):
    import pickle

    world = 2 * dp
    store = str(tmp / "store")
    outs = [str(tmp / f"rank{k}.pkl") for k in range(world)]
    _spawn(_rank_main, lambda k: (k, world, dp, store, outs[k], bn_world),
           world)
    dumps = []
    for o in outs:
        with open(o, "rb") as fp:
            dumps.append(pickle.load(fp))
    return dumps


@pytest.fixture(scope="module", params=[1, 2], ids=["dp1xtp2", "dp2xtp2"])
def ranks(request, tmp_path_factory):
    """(dp, the ranks' dumps after one sharded step, their directory)."""
    tmp = tmp_path_factory.mktemp(f"tp{request.param}")
    return request.param, _run_ranks(tmp, request.param), tmp


@pytest.fixture(scope="module")
def one_process():
    """The one-process port step at batch 4: its dump and gradients."""
    images, targets = _batch()
    state = train.init_train_state(SPEC, weights.synthetic_params(SPEC, 5),
                                   lr=LR, device="cpu")
    state, metrics = train.make_train_step(SPEC)(
        state, torch.from_numpy(images),
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


def _loss(dp, dumps):
    """The global batch's loss: the mean over the dp indices (every tp
    rank of one dp index holds the same loss)."""
    return np.mean([dumps[2 * d]["loss"] for d in range(dp)])


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_make_mesh_layouts_match_jax(n, cpu_devices):
    """Default, pinned dp and pinned tp degrees equal the JAX mesh's
    shape; an impossible layout raises in both."""
    from fastdet_tpu.parallel import mesh as jax_mesh

    devs = ["cpu"] * n
    cases = [{}] + [{"dp": d} for d in range(1, n + 1) if n % d == 0] \
        + [{"tp": t} for t in range(1, n + 1) if n % t == 0]
    for kw in cases:
        got = mesh.make_mesh(devs, **kw)
        want = jax_mesh.make_mesh(cpu_devices[:n], **kw)
        assert got.shape == dict(want.shape), kw
        assert got.devices == (torch.device("cpu"),) * n
    if n > 1:
        bad = {"dp": n, "tp": 2}
        with pytest.raises(ValueError, match="devices"):
            mesh.make_mesh(devs, **bad)
        with pytest.raises(AssertionError):
            jax_mesh.make_mesh(cpu_devices[:n], **bad)


@pytest.mark.parametrize("tp", [1, 2, 4, 3])
@pytest.mark.parametrize("arch", ["tiny", "full"])
def test_sharded_convs_match_param_shardings(arch, tp, cpu_devices):
    """The convs sharded over 'tp' are the JAX ``param_shardings``' (at
    least TP_MIN_CHANNELS filters, dividing by tp)."""
    from jax.sharding import PartitionSpec as P

    from fastdet_tpu.models import yolov3 as jax_yolov3
    from fastdet_tpu.parallel import mesh as jax_mesh

    assert mesh.TP_MIN_CHANNELS == jax_mesh.TP_MIN_CHANNELS == 256
    jspec = jax_yolov3.get_spec(arch, 80)
    jmesh = jax_mesh.make_mesh(cpu_devices[:tp], dp=1, tp=tp)
    params = {l.name: {"w": None, "b": None} for l in jspec.conv_specs()}
    want = {name: sh["w"].spec == P(None, None, None, "tp")
            for name, sh in jax_mesh.param_shardings(
                jspec, jmesh, params).items()}
    got = mesh.param_shardings(yolov3.get_spec(arch, 80), tp)
    assert got == want
    assert any(got.values()) == (tp != 3)


@pytest.mark.parametrize("tp_rank", [0, 1])
def test_shard_params_match_jax_shards(tp_rank, cpu_devices):
    """A rank's slice of every leaf equals the JAX ``shard_params`` shard
    on the device at (dp 0, tp rank)."""
    from fastdet_tpu.models import weights as jax_weights
    from fastdet_tpu.models import yolov3 as jax_yolov3
    from fastdet_tpu.parallel import mesh as jax_mesh

    jspec = _small_spec(jax_yolov3)
    params = jax_weights.synthetic_params(jspec, 5)
    jmesh = jax_mesh.make_mesh(cpu_devices[:4], dp=2, tp=2)
    dev = jmesh.devices[0, tp_rank]
    sharded = jax_mesh.shard_params(jspec, jmesh, params)
    got = mesh.shard_params(SPEC, mesh.make_mesh(["cpu"] * 4, dp=2, tp=2),
                            weights.synthetic_params(SPEC, 5), tp_rank)
    want = {(n, k): arr for n, k, arr in _leaves(sharded)}
    n = 0
    for name, leaf, g in _leaves(got):
        arr = want[(name, leaf)]
        shard = next(s for s in arr.addressable_shards if s.device == dev)
        np.testing.assert_array_equal(g, np.asarray(shard.data),
                                      err_msg=f"{name}/{leaf}")
        n += 1
    assert n == len(want) == sum(1 for _ in _leaves(params))


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

def test_ranks_hold_one_state(ranks):
    """Gathered over tp, every rank's parameters, BN statistics and Adam
    moments are the same bit for bit; the wide convs are held as halves."""
    dp, dumps, _ = ranks
    a = dumps[0]
    for b in dumps[1:]:
        for (_, _, x), (_, _, y) in zip(_leaves(a["params"]),
                                        _leaves(b["params"])):
            np.testing.assert_array_equal(x, y)
        for k in a["moments"]:
            for x, y in zip(a["moments"][k], b["moments"][k]):
                np.testing.assert_array_equal(x, y)
    sharded = mesh.param_shardings(SPEC, 2)
    for l, shape in zip(SPEC.conv_specs(), a["shards"]):
        assert shape[0] == (l.filters // 2 if sharded[l.name]
                            else l.filters), l.name


def test_sharded_step_matches_one_process_step(ranks, one_process):
    dp, dumps, _ = ranks
    want, grads = one_process
    np.testing.assert_allclose(_loss(dp, dumps), want["loss"], rtol=1e-5)
    _assert_step_close(dumps[0]["params"], want["params"], grads)
    assert dumps[0]["moments"].keys() == want["moments"].keys()
    for k, (m, v) in dumps[0]["moments"].items():
        wm, wv = want["moments"][k]
        assert np.abs(m - wm).max() <= 1e-4 * np.abs(wm).max(), k
        assert np.abs(v - wv).max() <= 2e-4 * np.abs(wv).max(), k


def test_sharded_step_matches_jax_sharded_step(ranks, one_process,
                                               cpu_devices):
    """The JAX step over a dp x 2 mesh of virtual CPU devices (GSPMD's
    channel sharding), from the same parameters on the same batch."""
    import jax
    import jax.numpy as jnp

    from fastdet_tpu.models import weights as jax_weights
    from fastdet_tpu.models import yolov3 as jax_yolov3
    from fastdet_tpu.parallel import mesh as jax_mesh
    from fastdet_tpu.parallel import train as jax_train

    dp, dumps, _ = ranks
    jspec = _small_spec(jax_yolov3)
    params = jax.tree_util.tree_map(
        jnp.asarray, jax_weights.synthetic_params(jspec, 5))
    jmesh = jax_mesh.make_mesh(cpu_devices[:2 * dp], dp=dp, tp=2)
    step, state = jax_train.make_sharded_train_step(
        jspec, jmesh, jax_train.make_optimizer(LR), params)
    images, targets = _batch()
    img, tgt = jax_train.shard_batch(jmesh, images, targets)
    state, metrics = step(state, img, *tgt)
    _, grads = one_process
    np.testing.assert_allclose(_loss(dp, dumps), float(metrics["loss"]),
                               rtol=1e-5)
    _assert_step_close(dumps[0]["params"],
                       jax.tree_util.tree_map(np.asarray, state.params),
                       grads)


def test_clip_norm_counts_each_shard_once(ranks, one_process):
    """The global gradient norm over the shards (squares summed over the
    tp group, replicated convs once) is the one-process step's."""
    _, dumps, _ = ranks
    want, _ = one_process
    for d in dumps:
        np.testing.assert_allclose(d["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)


def test_bn_over_the_world_would_differ(one_process, tmp_path):
    """At dp = 2 x tp = 2, BN statistics all-reduced over all four ranks
    add the two tp halves' channels together (their shapes match, so
    nothing fails): the BN running statistics then leave the tolerances
    that the dp-group step meets above far behind."""
    want, _ = one_process
    bad = _run_ranks(tmp_path, 2, bn_world=True)
    worst = 0.0
    for (name, leaf, x), (_, _, y) in zip(_leaves(bad[0]["params"]),
                                          _leaves(want["params"])):
        if leaf in ("mean", "var"):
            worst = max(worst, float((np.abs(x - y)
                                      / (1e-7 + 1e-5 * np.abs(y))).max()))
    assert worst > 100.0


def test_gathered_export_loads_with_jax_load_model(ranks, one_process):
    """Rank 0's export, gathered over tp, is the full tree: the JAX
    ``load_model`` reads it, equal to the gathered state."""
    from fastdet_tpu.models import weights as jax_weights

    _, dumps, tmp = ranks
    spec, params = jax_weights.load_model(str(tmp / "export.npz"))
    assert (spec.name, spec.num_classes) == ("yolov3-tiny", 4)
    got = {(n, k): v for n, k, v in _leaves(params)}
    for name, leaf, v in _leaves(dumps[0]["params"]):
        np.testing.assert_array_equal(np.asarray(got[(name, leaf)]), v)


def test_checkpoint_restores_into_the_shards(ranks):
    """save gathers the shards (parameters, BN statistics, Adam moments)
    into one file; restore cuts it back into a fresh sharded state, equal
    bit for bit on every rank."""
    _, dumps, _ = ranks
    assert all(d["restored_equal"] for d in dumps)


def _cli(argv, world_size):
    from fastdet_tpu_torch.cli import train as train_cli

    assert train_cli.main(argv, device="cpu", world_size=world_size) == 0


@pytest.mark.parametrize("ranks_n,layout", [(2, {"dp": 1, "tp": 2}),
                                            (4, {"dp": 2, "tp": 2})])
def test_cli_train_default_layout_exports_the_one_rank_export(
        tmp_path, ranks_n, layout):
    """cli.train(world_size=2 or 4) lays the JAX default mesh, dp = 1 or
    2 x tp = 2, and exports what the one-rank run exports (one step at
    batch 4: BN statistics rtol 1e-5, other values within 2·lr + 1e-6
    and all but 1 % within 1e-6); the export serves: the port's YoloNet
    runs it."""
    assert mesh.make_mesh(["cpu"] * ranks_n).shape == layout
    outs = {}
    for world in (1, ranks_n):
        out = str(tmp_path / f"w{world}.npz")
        argv = ["train", "--synthetic", "-a", "tiny", "-c", "4",
                "--image-size", "64", "--steps", "1", "--batch", "4",
                "--log-every", "1", "-o", out]
        if world == 1:
            _cli(argv, 1)
        else:   # the CLI spawns the ranks: run it in a joined process
            _spawn(_cli, lambda k: (argv, world), 1)
        outs[world] = np.load(out)
    a, b = outs[1], outs[ranks_n]
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
    spec, params = weights.load_model(str(tmp_path / f"w{ranks_n}.npz"))
    net = yolov3.YoloNet(spec, weights.fold_params(spec, params),
                         device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(
        1, 416, 416, 3).astype(np.float32))
    heads = net(x)
    assert [tuple(h.shape) for h in heads] == [(1, 13, 13, 27),
                                               (1, 26, 26, 27)]
    assert all(bool(torch.isfinite(h).all()) for h in heads)
