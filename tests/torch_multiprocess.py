"""Worker processes of ``tests/test_torch_multiprocess.py`` (not a test file).

:func:`run_group` starts ``world`` processes of ``python -m
tests.torch_multiprocess <kind> <rank> <world> <work dir>``, each with
torchrun's variables and one thread, waits for them with a timeout of
their own, and returns what each wrote (a pickle in the work directory, written by
these processes alone). The kinds:

- ``port``: ``initialize_multihost(backend="gloo")`` and
  ``make_mesh(process_devices=["cpu"] * k)`` (``k`` shards per process);
  three steps of ``make_sharded_train_step`` on the tiny ARU of
  ``tests/test_torch_data_parallel.py`` from the init in ``args.pkl``, and
  three steps of ``TrainerGNN._make_sharded_train_step`` (weight decay, EMA,
  node-feature dropout) from a seeded init; after every step the loss and
  every local replica's parameters and optimizer state. Also the mesh's
  placement and the refusals of the callers that drive every shard from one
  process.
- ``jax``: the JAX package's own ``initialize_multihost``, ``make_mesh``,
  ``replicate``, ``shard_batch`` and ``jax.jit(make_train_step)`` in a JAX
  CPU process with ``k`` devices (``XLA_FLAGS`` set by :func:`run_group`),
  from the same init: the losses and parameters after every step.

This module imports no JAX at its top: the port's processes never load it.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8                     # pages (graphs) per batch
STEPS = 3
GP = {"graph": "ARU", "featRoot": 4, "scale_space_num": 3, "res_depth": 2}
GNN_FLAGS = {"weight_decay": 1e-3, "ema_decay": 0.5, "batch_size": N}
GNN_PARAMS = {"dropout_rate_node_features": 0.3}
#: the seconds each started process may take before its group fails
TIMEOUT = 120


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def seg_batch(step, hw=64):
    """Step ``step``'s 8 pages (``tests/test_torch_data_parallel.py``'s):
    page i keeps the top (i + 1) / 9 of its rows valid, so every shard
    carries another weight."""
    rng = np.random.RandomState(100 + step)
    mask = np.zeros((N, hw, hw), np.float32)
    for i in range(N):
        mask[i, :hw * (i + 1) // 9] = 1.0
    return {"image": rng.rand(N, hw, hw, 1).astype(np.float32),
            "label": rng.randint(0, 2, (N, hw, hw)).astype(np.int32), "mask": mask}


def gnn_batch(step):
    """One graph per page of 3 to 8 nodes (9 to 64 valid relations), padded
    to node bucket 8, 56 edges and 64 relations
    (``tests/test_torch_data_parallel.py``'s)."""
    from citlab_as_tpu_torch.models.gnn.graph import (
        batch_graphs, build_full_relations, correct_edges, fully_connected_edges, pad_graph,
    )
    rng = np.random.RandomState(200 + step)
    graphs = []
    for n in (3, 8, 4, 7, 5, 6, 8, 3):
        edges, efeats = correct_edges(fully_connected_edges(n),
                                      rng.rand(n * (n - 1), 2).astype(np.float32), n)
        gt = np.array([[1, i, j] for i in range(n) for j in range(n)
                       if (i < n // 2) == (j < n // 2)], np.int32)
        rels, _, gts = build_full_relations(n, gt)
        graphs.append(pad_graph(n, 4 * rng.rand(n, 15).astype(np.float32), edges, efeats,
                                rels, gts, 8, 56, 64))
    return batch_graphs(graphs)


def tensors(tree):
    """A tree of tensors (and counters) as numpy copies, for pickling."""
    import torch
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tensors(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


# ---------------------------------------------------------------- the port

def seg_model(init):
    from citlab_as_tpu_torch.train.segmentation import create_model
    from citlab_as_tpu_torch.weights import arunet_state_dict_from_flax
    model = create_model(2, GP, None)
    model.load_state_dict(arunet_state_dict_from_flax(init))
    return model


def constant_adam():
    from citlab_as_tpu_torch.train.optimizer import adam
    return adam(lambda count: np.float32(1e-3))


def port_seg_steps(mesh, init):
    """The sharded segmentation step over ``mesh`` from ``init``: per step
    the loss and every local replica's parameters and Adam state."""
    from citlab_as_tpu_torch.parallel.mesh import replicate, shard_batch
    from citlab_as_tpu_torch.train.segmentation import make_sharded_train_step
    replicas = replicate(mesh, seg_model(init))
    optimizer = constant_adam()
    params = [dict(r.named_parameters()) for r in replicas]
    states = [optimizer.init(p) for p in params]
    step = make_sharded_train_step(replicas, optimizer, mesh)
    out = []
    for i in range(STEPS):
        loss = step(params, states, shard_batch(mesh, seg_batch(i)))
        out.append({"loss": tensors(loss), "params": tensors(params),
                    "states": tensors(states)})
    return out


def port_gnn_steps(mesh, root):
    """The relation trainer's sharded step over ``mesh`` (weight decay, EMA,
    node-feature dropout) from its seeded init: per step the loss and every
    local replica's parameters, EMA and optimizer state."""
    from citlab_as_tpu_torch.models.gnn.model import GraphRelation
    from citlab_as_tpu_torch.parallel.mesh import replicate, shard_batch
    from citlab_as_tpu_torch.train import checkpoint as ckpt
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    trainer = TrainerGNN(root, [], [], flags=GNN_FLAGS, seed=0, device="cpu",
                         model=GraphRelation(15, 2, gnn_params=GNN_PARAMS))
    trainer._build_model(gnn_batch(0))
    replicas = replicate(mesh, trainer.model)
    params = [dict(r.named_parameters()) for r in replicas]
    states = [trainer.optimizer.init(p) for p in params]
    emas = [ckpt.ema_init(p) for p in params]
    step = trainer._make_sharded_train_step(mesh, replicas)
    out = []
    for i in range(STEPS):
        loss = step(params, states, shard_batch(mesh, gnn_batch(i)), emas)
        out.append({"loss": tensors(loss), "params": tensors(params),
                    "states": tensors(states), "emas": tensors(emas)})
    return out


def refusals(mesh, work):
    """What each caller that drives every shard from one process says to a
    mesh that spans processes: ``{caller: message}``, or the caller's
    result where it did not refuse."""
    from citlab_as_tpu_torch.cli import run_net_post_processing
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow_pipelined
    from citlab_as_tpu_torch.inference import RelationPredictor, ShardedSegmentationPredictor
    from citlab_as_tpu_torch.parallel.mesh import spatial_sharding
    separator = os.path.join(REPO, "models_ckpt_torch", "separator.npz")
    lst = os.path.join(work, f"images_{mesh.process_index}.lst")
    with open(lst, "w") as f:
        f.write(os.path.join(work, "page.png") + "\n")
    run_net_post_processing._mesh_for = lambda device: mesh
    calls = {
        "ShardedSegmentationPredictor": lambda: ShardedSegmentationPredictor(separator,
                                                                             mesh=mesh),
        "RelationPredictor": lambda: RelationPredictor(None, mesh=mesh),
        "run_full_workflow_pipelined": lambda: run_full_workflow_pipelined(
            [os.path.join(work, "page.png")], mesh=mesh, device="cpu"),
        "run_net_post_processing --sharded": lambda: run_net_post_processing.main(
            ["--path_to_image_list", lst, "--mode", "separator", "--model", separator,
             "--sharded", "--device", "cpu"]),
        "SpatialARU (spatial_sharding)": lambda: spatial_sharding(mesh),
        "SpatialARU (model_devices)": lambda: mesh.model_devices(mesh.local_rows[0]),
    }
    out = {}
    for caller, call in calls.items():
        try:
            out[caller] = repr(call())
        except ValueError as e:
            out[caller] = str(e)
    return out


def port_worker(rank, world, work):
    import torch
    import torch.distributed as dist
    from citlab_as_tpu_torch.parallel.mesh import (
        initialize_multihost, make_mesh, replicate, shard_batch,
    )
    torch.set_num_threads(1)
    with open(os.path.join(work, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    assert initialize_multihost(backend="gloo") is True
    try:
        mesh = make_mesh(process_devices=["cpu"] * args["shards"])
        rows = np.arange(2 * mesh.shape["data"])[:, None]
        out = {
            "backend": dist.get_backend(), "shape": dict(mesh.shape),
            "local_rows": list(mesh.local_rows), "data_devices": len(mesh.data_devices),
            "shard_rows": [p[:, 0].tolist() for p in shard_batch(mesh, rows)],
            "replicas": len(replicate(mesh, torch.zeros(1))),
            "seg": port_seg_steps(mesh, args["init"]),
        }
        if args.get("gnn"):
            out["gnn"] = port_gnn_steps(mesh, os.path.join(work, f"gnn_{rank}"))
        if args.get("refusals"):
            out["refusals"] = refusals(mesh, work)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


# ---------------------------------------------------------------- the JAX oracle

def jax_worker(rank, world, work):
    """The JAX package's train step jitted over a mesh of every process's
    CPU devices, as ``__graft_entry__`` runs it on one host."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import traverse_util
    from citlab_as_tpu.models.arunet import ARUNet
    from citlab_as_tpu.parallel import mesh as jmesh
    from citlab_as_tpu.train.segmentation import make_train_step
    with open(os.path.join(work, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    assert jmesh.initialize_multihost(os.environ["JAX_COORDINATOR_ADDRESS"], world, rank)
    mesh = jmesh.make_mesh()
    model = ARUNet(n_classes=2, dtype=jnp.float32, graph_params=GP)
    params = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in args["init"].items()})
    optimizer = optax.adam(1e-3)
    opt_state = optimizer.init(params)
    params, opt_state = jmesh.replicate(mesh, params), jmesh.replicate(mesh, opt_state)
    step = jax.jit(make_train_step(model, optimizer))

    def local(x):
        return np.asarray(x.addressable_data(0))
    out = {"devices": len(jax.devices()), "local_devices": len(jax.local_devices()),
           "shape": dict(mesh.shape), "steps": []}
    for i in range(STEPS):
        params, opt_state, loss = step(params, opt_state, jmesh.shard_batch(mesh, seg_batch(i)))
        out["steps"].append({"loss": float(local(loss)), "params": {
            k: local(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}})
    return out


# ---------------------------------------------------------------- the group

def run_group(kind, world, work, **args):
    """``world`` processes of ``kind`` over one coordinator port; returns
    each rank's result. A process that fails, or outlives ``TIMEOUT``
    seconds, fails the group with its output."""
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "args.pkl"), "wb") as f:
        pickle.dump(args, f)
    port = str(free_port())
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    if kind == "jax":
        env.update(JAX_PLATFORMS="cpu", JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={args['shards']}")
    procs = []
    try:
        for rank in range(world):
            log = open(os.path.join(work, f"log_{rank}.txt"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "tests.torch_multiprocess", kind, str(rank),
                 str(world), work], cwd=REPO, env=dict(env, RANK=str(rank)),
                stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + TIMEOUT
        for proc, _ in procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    results = []
    for rank, (proc, _) in enumerate(procs):
        path = os.path.join(work, f"result_{rank}.pkl")
        if proc.returncode != 0 or not os.path.exists(path):
            with open(os.path.join(work, f"log_{rank}.txt")) as f:
                raise RuntimeError(f"{kind} process {rank} of {world} exited with "
                                   f"{proc.returncode} (killed after {TIMEOUT} s if "
                                   f"negative):\n{f.read()[-4000:]}")
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def main(argv):
    kind, rank, world, work = argv[0], int(argv[1]), int(argv[2]), argv[3]
    try:
        out = (port_worker if kind == "port" else jax_worker)(rank, world, work)
    except Exception:
        traceback.print_exc()
        return 1
    with open(os.path.join(work, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
