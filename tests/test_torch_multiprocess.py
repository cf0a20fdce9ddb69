"""Data-parallel training across processes on the CPU: the port's
``parallel/mesh.py`` over a ``torch.distributed`` group of ``gloo``
processes, against the one-process mesh of as many shards and against the
JAX package's own multi-process step.

Three groups of processes run at once (``tests/torch_multiprocess.py``,
one thread each, each process with a timeout of its own):

- the port, 4 processes of one CPU shard each (``make_mesh(process_devices=
  ["cpu"])``), and 2 processes of two shards each: 3 steps of
  ``make_sharded_train_step`` on the tiny ARU of
  ``tests/test_torch_data_parallel.py`` (``GP``, 64 x 64 pages, the JAX
  init), 3 steps of the relation trainer's sharded step with weight decay
  1e-3, EMA 0.5 and node-feature dropout 0.3;
- the JAX package, 2 processes of two CPU devices each
  (``jax.distributed`` through its ``initialize_multihost``, ``make_mesh``,
  ``replicate``, ``shard_batch`` and ``jax.jit(make_train_step)``).

Gates: each process's loss, parameters and optimizer state (and EMA) bit-equal
after every step to those of ``make_sharded_train_step`` over
``make_mesh(["cpu"] * 4)`` in this process, and the replicas bit-equal across
the processes; the port's two processes within ``TOL`` (losses) and
``ADAM_EPS_TOL`` (parameter leaves) of the JAX processes; where each process's
shards lie, and the refusals of the callers that drive every shard from one
process; the card-pinning rule.
"""
import concurrent.futures
import functools
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from citlab_as_tpu.models.arunet import ARUNet as JARUNet
from citlab_as_tpu_torch.parallel import mesh as tmesh
from citlab_as_tpu_torch.weights import arunet_flax_from_state_dict
from tests import torch_multiprocess as procs
from tests.test_torch_data_parallel import ADAM_EPS_TOL, TOL, assert_leaves_close

SHARDS = 4
#: (processes, shards per process) of the port's groups
LAYOUTS = ((4, 1), (2, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The in-process reference runs in one thread, as each process does:
    the CPU convolutions then sum in the same order on both sides."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def seg_init():
    """The JAX init of the tiny ARU, as flat numpy arrays."""
    model = JARUNet(n_classes=2, dtype=jnp.float32, graph_params=procs.GP)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


@functools.cache
def runs():
    """Every group's results: ``{(4, 1): [...], (2, 2): [...], "jax": [...]}``,
    one entry per process, and the in-process reference under "one"."""
    work = tempfile.mkdtemp(prefix="torch_multiprocess_")
    try:
        init = seg_init()
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            futures = {layout: pool.submit(
                procs.run_group, "port", layout[0], os.path.join(work, f"port_{layout[0]}"),
                shards=layout[1], init=init, gnn=True, refusals=layout == (4, 1))
                for layout in LAYOUTS}
            futures["jax"] = pool.submit(procs.run_group, "jax", 2, os.path.join(work, "jax"),
                                         shards=2, init=init)
            mesh = tmesh.make_mesh(["cpu"] * SHARDS)
            out = {"one": {"seg": procs.port_seg_steps(mesh, init),
                           "gnn": procs.port_gnn_steps(mesh, os.path.join(work, "one"))}}
            out.update({key: future.result() for key, future in futures.items()})
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def assert_trees_equal(got, want, label):
    """Two trees of numpy arrays (and counters) equal bit for bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), label
        for k in want:
            assert_trees_equal(got[k], want[k], f"{label}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), label
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(a, b, f"{label}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, label
        assert np.array_equal(np.atleast_1d(got).view(np.uint8),
                              np.atleast_1d(want).view(np.uint8)), label
    else:
        assert got == want, label


def shard_states(result, kind, step):
    """The per-shard trees of one process after ``step``: ``[(global shard,
    {"params": ..., "states": ...[, "emas": ...]})]``."""
    entry = result[kind][step]
    keys = [k for k in ("params", "states", "emas") if k in entry]
    return [(g, {k: entry[k][i] for k in keys}) for i, g in enumerate(result["local_rows"])]


def check_against_one_process(layout, kind):
    got, want = runs()[layout], runs()["one"][kind]
    for step in range(procs.STEPS):
        first = shard_states(got[0], kind, step)[0][1]
        for rank, result in enumerate(got):     # (h) replicas equal across processes
            for g, tree in shard_states(result, kind, step):
                assert_trees_equal(tree, first, f"{layout} {kind} step {step}: process "
                                                f"{rank}'s shard {g} against process 0's")
        for rank, result in enumerate(got):
            label = f"{layout} {kind} step {step} process {rank}"
            assert_trees_equal(result[kind][step]["loss"], want[step]["loss"], label + " loss")
            for g, tree in shard_states(result, kind, step):
                assert_trees_equal(tree, {k: want[step][k][g] for k in tree},
                                   f"{label} shard {g}")


def test_four_processes_of_one_shard_equal_the_one_process_mesh():
    """(a) and (h). Four processes of one CPU shard: the segmentation step's
    losses, parameters and Adam slots bit-equal after each of 3 steps to
    ``make_sharded_train_step`` over ``make_mesh(["cpu"] * 4)``, and the
    replicas bit-equal across the processes. The replicas' assertion is the
    guard of the fault this slice repairs: with the parent commit's
    ``reduce_gradients`` and ``sum_on_first``, which sum the shards of their
    own process only, each process applies its own shard's gradient and
    the replicas part after the first step (checked in a copy of the tree
    whose ``_every_shard`` returns the local shards alone)."""
    check_against_one_process((4, 1), "seg")


def test_two_processes_of_two_shards_equal_the_one_process_mesh():
    """(b) Two processes of two shards each against the same 4-shard step,
    bit for bit: the shards are summed in global shard order (process 0's
    two, then process 1's), as in one process."""
    check_against_one_process((2, 2), "seg")


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda layout: f"{layout[0]}x{layout[1]}")
def test_relation_step_across_processes_equals_the_one_process_mesh(layout):
    """(c) The relation trainer's sharded step with weight decay 1e-3, EMA 0.5
    and node-feature dropout 0.3: losses, parameters, EMA and optimizer
    state bit-equal to the in-process 4-shard step, so the L2 term lies on
    global shard 0 alone and dropout draws ``seed + global shard``."""
    check_against_one_process(layout, "gnn")
    assert procs.GNN_PARAMS["dropout_rate_node_features"] > 0


def test_port_processes_hold_to_the_jax_processes():
    """(d) The JAX package's own multi-process step, two JAX CPU processes
    of two devices each over one mesh of 4, against the port's two
    processes of two shards from the same init: losses within ``TOL``,
    every parameter leaf within ``ADAM_EPS_TOL`` of its norm after each
    step (``tests/test_torch_data_parallel.py`` says why not ``TOL``)."""
    jax_runs, port = runs()["jax"], runs()[(2, 2)]
    for result in jax_runs:
        assert result["devices"] == 4 and result["local_devices"] == 2
        assert result["shape"] == {"data": 4, "model": 1}
    for step in range(procs.STEPS):
        want = jax_runs[0]["steps"][step]
        for result in jax_runs[1:]:
            assert result["steps"][step]["loss"] == want["loss"]
        for result in port:
            got = result["seg"][step]
            np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=TOL)
            flat = arunet_flax_from_state_dict(
                {k: torch.from_numpy(v) for k, v in got["params"][0].items()})
            assert_leaves_close({k: np.asarray(v) for k, v in flat.items()},
                                want["params"], ADAM_EPS_TOL)


def test_placement_across_processes():
    """(e) ``make_mesh`` spans every process's shards (global shape), each
    process holds its own rows in rank order, and ``shard_batch`` gives
    global shard g the rows ``[2 g, 2 g + 2)`` of the whole batch that
    every process passes; ``replicate`` copies onto this process's rows
    only."""
    for (n_procs, per), results in ((layout, runs()[layout]) for layout in LAYOUTS):
        for rank, result in enumerate(results):
            rows = list(range(rank * per, (rank + 1) * per))
            assert result["backend"] == "gloo"
            assert result["shape"] == {"data": SHARDS, "model": 1}
            assert result["local_rows"] == rows
            assert result["data_devices"] == result["replicas"] == per
            assert result["shard_rows"] == [[2 * g, 2 * g + 1] for g in rows]


def test_mesh_rows_belong_to_one_process_each():
    """A mesh's data rows: whole, as many per process, in rank order."""
    devices = np.empty((4, 1), dtype=object)
    devices[:] = [[torch.device("cpu")]] * 4
    mesh = tmesh.Mesh(devices, np.array([[0], [0], [1], [1]]), process_index=1)
    assert mesh.local_rows == [2, 3] and mesh.spans_processes and mesh.process_count == 2
    for owners in ([[0], [1], [0], [1]], [[0], [0], [0], [1]]):
        with pytest.raises(ValueError, match="rank order"):
            tmesh.Mesh(devices, np.array(owners))
    grid = np.empty((2, 2), dtype=object)
    grid[:] = [[torch.device("cpu")] * 2] * 2
    with pytest.raises(ValueError, match="whole data rows"):
        tmesh.Mesh(grid, np.array([[0, 1], [0, 1]]))
    with pytest.raises(ValueError, match="not both"):
        tmesh.make_mesh(["cpu"], process_devices=["cpu"])
    one = tmesh.make_mesh(process_devices=["cpu"] * 2)     # no group: this process's
    assert not one.spans_processes and one.local_rows == [0, 1]


@pytest.mark.parametrize("caller", [
    "ShardedSegmentationPredictor", "RelationPredictor", "run_full_workflow_pipelined",
    "run_net_post_processing --sharded", "SpatialARU (spatial_sharding)",
    "SpatialARU (model_devices)"])
def test_callers_of_one_process_refuse_a_mesh_across_processes(caller):
    """(f) The callers that drive every shard of their mesh from one process
    refuse a mesh across 4 processes by name, where they would otherwise
    run on their local rows (the JAX package cannot read such a run's
    array back either)."""
    name = caller.split(" (")[0]
    for result in runs()[(4, 1)]:
        message = result["refusals"][caller]
        assert name in message and "spans 4 processes" in message, message


def test_card_pinning_rule():
    """(g) ``process_cards``: torchrun's processes on one host take card
    ``LOCAL_RANK`` each; one process per host (or no torchrun) every
    visible card; a local rank past the cards is refused."""
    assert tmesh.process_cards({}, 4) == [0, 1, 2, 3]
    assert tmesh.process_cards({"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}, 2) == [0, 1]
    assert tmesh.process_cards({"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "4"}, 4) == [2]
    assert tmesh.process_cards({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "8"}, 8) == [1]
    with pytest.raises(ValueError, match="LOCAL_RANK 1"):
        tmesh.process_cards({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, 1)
    assert tmesh.local_devices() == [torch.device("cpu")]


def test_initialize_multihost_pins_the_process_to_its_card(monkeypatch):
    """(g) Under torchrun's variables for the third of four processes on a
    host of four cards: the process is pinned to card 2 before the group
    comes up, and the backend is ``nccl``."""
    import torch.distributed as dist
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: calls.append(("pin", dev)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw["rank"])))
    for var, value in (("LOCAL_WORLD_SIZE", "4"), ("LOCAL_RANK", "2")):
        monkeypatch.setenv(var, value)
    assert tmesh.initialize_multihost("localhost:1", 4, 2) is True
    assert calls == [("pin", torch.device("cuda", 2)), ("nccl", 2)]
