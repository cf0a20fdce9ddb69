"""Data-parallel training in the port (``parallel/mesh.py::reduce_gradients``,
``train/segmentation.py::make_sharded_train_step``,
``train/trainer.py::TrainerGNN._make_sharded_train_step``) against the JAX
package's train steps jitted over a replicated state and a sharded batch on
its 8 virtual CPU devices (``conftest.py``), on the CPU.

- Segmentation: the step ``__graft_entry__._dryrun_impl`` runs,
  ``jax.jit(make_train_step(model, optax.adam(1e-3)))`` over
  ``make_mesh(jax.devices()[:8], data=8, model=1)`` with ``replicate`` and
  ``shard_batch``, on its tiny f32 ARU (featRoot 4, 3 scales, res_depth 2),
  over 8 seeded 64 x 64 pages whose validity masks keep a different share
  of each shard's pixels. The port's step over ``make_mesh(["cpu"] * 8)``
  from the converted JAX init: each of 3 losses within 1e-5 relative and
  every parameter leaf within 1e-4 of its norm after each step (1e-5 after
  the first two; at the third, one element of the 12 of
  ``attMapG/conv1/conv/bias`` lies 8.5e-6 from JAX's, 2.5e-5 of the leaf's
  norm: its gradient is a sum over 32,768 pixels that cancels to 8.5e-4,
  and the JAX step's own fused sum of it lies 1.7 % from ``jax.grad`` of
  the same loss at the same parameters, where the port's lies within 6e-7
  of ``jax.grad``'s; Adam divides it by its root mean square, which turns
  that noise into a step difference); the 8
  replicas' parameters and Adam slots bit-equal after each step; the port's
  unsharded step on the whole batch held to the same tolerances (the CPU's
  convolutions sum a batch of 1 and of 8 in other orders). On that batch
  the mean of the shards' own losses lies further from the whole batch's
  loss than the tolerance, so a step that averaged shard means would fail.
- Class weights (the separator recipe's 8 : 1), which the JAX step does not
  take: sharded against the port's unsharded step, over shards with unequal
  class counts.
- Relation GNN: the JAX trainer's own jitted step
  (``TrainerGNN._make_train_step``: ``GraphRelation.apply``,
  ``relation_loss`` with weight decay 1e-3, optax, EMA 0.5) over the 8
  devices, one graph per shard of 3 to 8 nodes (9 to 64 valid relations):
  losses within 1e-5 relative over 3 steps, parameters and EMA leaves
  within 1e-5 of their norms, replicas bit-equal.
- Zero gradients: ``reduce_gradients`` takes a shard's None as a zero; the
  ``ARU_v1`` visual net's sharded step, whose backbone up path no shard's
  loss reaches, equals the unsharded step.

The JAX steps are compiled once per module (about 10 s on this file's
first use in a process).
"""
import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from citlab_as_tpu.models.arunet import ARUNet as JARUNet
from citlab_as_tpu.models.gnn.model import GraphRelation as JGraphRelation
from citlab_as_tpu.parallel import mesh as jmesh
from citlab_as_tpu.train.segmentation import make_train_step as jmake_train_step
from citlab_as_tpu.train.trainer import TrainerGNN as JTrainerGNN
from citlab_as_tpu_torch.models.gnn.graph import (
    batch_graphs, build_full_relations, correct_edges, fully_connected_edges, pad_graph,
)
from citlab_as_tpu_torch.models.gnn.loss import relation_loss
from citlab_as_tpu_torch.models.gnn.model import GraphRelation
from citlab_as_tpu_torch.parallel import mesh as tmesh
from citlab_as_tpu_torch.train import checkpoint as ckpt
from citlab_as_tpu_torch.train.input_pipeline import InputGNN
from citlab_as_tpu_torch.train.optimizer import adam
from citlab_as_tpu_torch.train.segmentation import (
    create_model, make_sharded_train_step, make_train_step, segmentation_loss,
)
from citlab_as_tpu_torch.train.trainer import TrainerGNN
from citlab_as_tpu_torch.weights import (
    arunet_flax_from_state_dict, arunet_state_dict_from_flax, gnn_flax_from_state_dict,
)
from tests.test_torch_visual_training import INPUT, write_visual_graphs

TOL = 1e-5
#: the parameters against the JAX segmentation step (see the module docstring)
ADAM_EPS_TOL = 1e-4
N = 8
STEPS = 3
GP = {"graph": "ARU", "featRoot": 4, "scale_space_num": 3, "res_depth": 2}
GNN_FLAGS = {"weight_decay": 1e-3, "ema_decay": 0.5, "batch_size": N}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eight shards run hundreds of small CPU ops each: with the test
    workers of a parallel run each spinning up every core's thread for
    them, they run a hundred times slower than in one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def assert_leaves_close(got, want, tol=TOL):
    """Every leaf's difference norm within ``tol`` of the leaf's norm."""
    assert sorted(got) == sorted(want)
    for k in want:
        diff = np.linalg.norm(np.asarray(got[k], np.float64) - want[k])
        assert diff <= tol * max(np.linalg.norm(want[k]), 1e-30), (k, diff)


def assert_replicas_equal(trees):
    """Every replica's tensors (parameters, optimizer slots) bit-equal to
    the first replica's."""
    first = tmesh._leaves(trees[0])
    for tree in trees[1:]:
        leaves = tmesh._leaves(tree)
        assert len(leaves) == len(first)
        for a, b in zip(leaves, first):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
            else:
                assert a == b


def flax_copy(convert, params):
    """The flat flax tree of ``params`` as copies (the converters' arrays
    share the live tensors' memory)."""
    return {k: np.array(v) for k, v in convert(params).items()}


def _opt_tensors(state):
    return {k: v for k, v in state.items() if isinstance(v, dict)}


# ---------------------------------------------------------------- segmentation

def seg_batch(step, hw=64):
    """Step ``step``'s 8 pages; page i keeps the top (i + 1) / 9 of its rows
    valid, so every shard carries another weight."""
    rng = np.random.RandomState(100 + step)
    mask = np.zeros((N, hw, hw), np.float32)
    for i in range(N):
        mask[i, :hw * (i + 1) // 9] = 1.0
    return {"image": rng.rand(N, hw, hw, 1).astype(np.float32),
            "label": rng.randint(0, 2, (N, hw, hw)).astype(np.int32), "mask": mask}


@functools.cache
def jax_seg_run():
    """The JAX step of ``_dryrun_impl`` over the 8-device mesh: its init and,
    after each of 3 steps, the loss and the flat parameters."""
    mesh = jmesh.make_mesh(jax.devices()[:N], data=N, model=1)
    model = JARUNet(n_classes=2, dtype=jnp.float32, graph_params=GP)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    init = _flat(params)
    optimizer = optax.adam(1e-3)
    opt_state = optimizer.init(params)
    params, opt_state = jmesh.replicate(mesh, params), jmesh.replicate(mesh, opt_state)
    step = jax.jit(jmake_train_step(model, optimizer))
    losses, trees = [], []
    for i in range(STEPS):
        params, opt_state, loss = step(params, opt_state, jmesh.shard_batch(mesh, seg_batch(i)))
        assert len(loss.sharding.device_set) == N
        losses.append(float(loss))
        trees.append(_flat(params))
    return init, losses, trees


def port_seg_model(init):
    model = create_model(2, GP, torch.float32)
    model.load_state_dict(arunet_state_dict_from_flax(init))
    return model


def constant_adam():
    return adam(lambda count: np.float32(1e-3))


def port_seg_runs(init, class_weights=None, batches=seg_batch):
    """The port's sharded step over 8 CPU shards and its unsharded step, from
    ``init``: per step the losses, the first replica's and the unsharded
    flat parameters, with the replicas checked bit-equal after each step."""
    mesh = tmesh.make_mesh(["cpu"] * N)
    model = port_seg_model(init)
    replicas = tmesh.replicate(mesh, model)
    optimizer = constant_adam()
    params = [dict(r.named_parameters()) for r in replicas]
    opt_states = [optimizer.init(p) for p in params]
    sharded = make_sharded_train_step(replicas, optimizer, mesh, class_weights)
    single = port_seg_model(init)
    single_params = dict(single.named_parameters())
    single_state = optimizer.init(single_params)
    unsharded = make_train_step(single, optimizer, class_weights)
    out = {"sharded": [], "unsharded": [], "params": [], "single": []}
    for i in range(STEPS):
        batch = batches(i)
        loss = sharded(params, opt_states, tmesh.shard_batch(mesh, batch))
        assert loss.dim() == 0 and loss.device == mesh.data_devices[0]
        assert_replicas_equal(params)
        assert_replicas_equal([_opt_tensors(s) for s in opt_states])
        assert [s["count"] for s in opt_states] == [i + 1] * N
        out["sharded"].append(float(loss))
        out["params"].append(flax_copy(arunet_flax_from_state_dict, params[0]))
        t = {k: torch.from_numpy(v) for k, v in batch.items()}
        out["unsharded"].append(float(unsharded(single_params, single_state, t)))
        out["single"].append(flax_copy(arunet_flax_from_state_dict, single_params))
    return out


@functools.cache
def port_seg_run():
    return port_seg_runs(jax_seg_run()[0])


def test_sharded_segmentation_step_equals_the_jax_step_over_8_devices():
    _, want_losses, want_trees = jax_seg_run()
    got = port_seg_run()
    np.testing.assert_allclose(got["sharded"], want_losses, rtol=TOL)
    for got_tree, want_tree in zip(got["params"], want_trees):
        assert_leaves_close(got_tree, want_tree, ADAM_EPS_TOL)


def test_sharded_segmentation_step_equals_the_unsharded_step():
    got = port_seg_run()
    np.testing.assert_allclose(got["sharded"], got["unsharded"], rtol=TOL)
    for sharded, single in zip(got["params"], got["single"]):
        assert_leaves_close(sharded, single)


def test_a_mean_of_shard_means_is_not_the_whole_batch_loss():
    """On the first batch, from the JAX init: the whole batch's loss (the
    JAX step's first loss) against the mean of the 8 shards' own losses."""
    init, want_losses, _ = jax_seg_run()
    model = port_seg_model(init)
    batch = {k: torch.from_numpy(v) for k, v in seg_batch(0).items()}
    with torch.no_grad():
        logits = model(batch["image"])
        whole = float(segmentation_loss(logits, batch["label"], batch["mask"]))
        means = [float(segmentation_loss(logits[i:i + 1], batch["label"][i:i + 1],
                                         batch["mask"][i:i + 1])) for i in range(N)]
    assert whole == pytest.approx(want_losses[0], rel=TOL)
    assert abs(np.mean(means) - whole) > 10 * TOL * whole, (np.mean(means), whole)


def test_sharded_segmentation_step_with_class_weights_equals_the_unsharded_step():
    def batches(step):
        batch = seg_batch(step)
        label = batch["label"]
        for i in range(N):                   # shard i: class 0 on i / 8 of its pixels
            label[i] = (np.random.RandomState(step * N + i).rand(64, 64) >= i / N)
        return dict(batch, label=label.astype(np.int32))

    got = port_seg_runs(jax_seg_run()[0], class_weights=(8.0, 1.0), batches=batches)
    np.testing.assert_allclose(got["sharded"], got["unsharded"], rtol=TOL)
    for sharded, single in zip(got["params"], got["single"]):
        assert_leaves_close(sharded, single)


# ---------------------------------------------------------------- relation GNN

def gnn_batch(step):
    """One graph per shard, of 3 to 8 nodes and so 9 to 64 valid relations
    (two articles each), padded to node bucket 8, 56 edges, 64 relations;
    node features in [0, 4), so that the init's logits already tell the
    graphs' losses apart."""
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


@functools.cache
def jax_gnn_run(root):
    """The JAX trainer's jitted step over the 8-device mesh: its init and,
    after each of 3 steps, the loss and the flat parameters and EMA."""
    mesh = jmesh.make_mesh(jax.devices()[:N], data=N, model=1)
    trainer = JTrainerGNN(root, [], [], flags=GNN_FLAGS,
                          model=JGraphRelation(num_classes=2), seed=0)
    state = trainer._init_state(gnn_batch(0))
    init = _flat(state["params"])
    state = jmesh.replicate(mesh, state)
    step = trainer._make_train_step()
    out = []
    for i in range(STEPS):
        state, loss = step(state, jmesh.shard_batch(mesh, gnn_batch(i)))
        out.append((float(loss), _flat(state["params"]), _flat(state["ema"])))
    return init, out


def test_sharded_relation_step_equals_the_jax_trainer_step_over_8_devices(tmp_path):
    init, want = jax_gnn_run(str(tmp_path / "jax"))
    mesh = tmesh.make_mesh(["cpu"] * N)
    trainer = TrainerGNN(str(tmp_path / "port"), [], [], flags=GNN_FLAGS, seed=0,
                         device="cpu", init_params=init)
    trainer._build_model(gnn_batch(0))
    single = copy.deepcopy(trainer.model)
    replicas = tmesh.replicate(mesh, trainer.model)
    params = [dict(r.named_parameters()) for r in replicas]
    opt_states = [trainer.optimizer.init(p) for p in params]
    emas = [ckpt.ema_init(p) for p in params]
    step = trainer._make_sharded_train_step(mesh, replicas)
    trainer.model = single
    single_params = dict(single.named_parameters())
    single_state, single_ema = trainer.optimizer.init(single_params), ckpt.ema_init(single_params)
    unsharded = trainer._make_train_step()
    first = {k: torch.from_numpy(v) for k, v in gnn_batch(0).items()}
    with torch.no_grad():         # at the init: each shard's own mean, L2 once
        logits = single(first)
        means = [float(relation_loss(logits[i:i + 1], first["relations_to_consider_gt"][i:i + 1],
                                     first["num_relations_to_consider"][i:i + 1]))
                 for i in range(N)]
        l2 = float(relation_loss(logits, first["relations_to_consider_gt"],
                                 first["num_relations_to_consider"], params=single_params,
                                 weight_decay=GNN_FLAGS["weight_decay"])) - float(
            relation_loss(logits, first["relations_to_consider_gt"],
                          first["num_relations_to_consider"]))
    assert len(set(first["num_relations_to_consider"].tolist())) > 1 and l2 > 0
    for wrong in (np.mean(means) + l2, want[0][0] + (N - 1) * l2):
        assert abs(wrong - want[0][0]) > 10 * TOL * want[0][0], (wrong, want[0][0])
    for i, (want_loss, want_params, want_ema) in enumerate(want):
        batch = gnn_batch(i)
        loss = step(params, opt_states, tmesh.shard_batch(mesh, batch), emas)
        assert float(loss) == pytest.approx(want_loss, rel=TOL)
        assert_replicas_equal(params)
        assert_replicas_equal(emas)
        assert_replicas_equal([_opt_tensors(s) for s in opt_states])
        assert_leaves_close(gnn_flax_from_state_dict(params[0]), want_params)
        assert_leaves_close(gnn_flax_from_state_dict(emas[0]), want_ema)
        single_loss = unsharded(single_params, single_state,
                                {k: torch.from_numpy(v) for k, v in batch.items()})
        ckpt.ema_update(single_ema, single_params, GNN_FLAGS["ema_decay"])
        assert float(single_loss) == pytest.approx(float(loss), rel=TOL)
        assert_leaves_close(gnn_flax_from_state_dict(single_params),
                            gnn_flax_from_state_dict(params[0]))


# ---------------------------------------------------------------- zero gradients

def test_reduce_gradients_takes_a_missing_gradient_as_zero():
    mesh = tmesh.make_mesh(["cpu"] * 3)
    like = [{"w": torch.zeros(2, 3), "b": torch.zeros(3), "up": torch.zeros(4)}
            for _ in range(3)]
    grads = [{"w": torch.full((2, 3), 1.0), "b": None, "up": None},
             {"w": None, "b": torch.arange(3.0), "up": None},
             {"w": torch.full((2, 3), 2.5), "b": torch.ones(3), "up": None}]
    out = tmesh.reduce_gradients(mesh, grads, like)
    for shard in out:
        assert torch.equal(shard["w"], torch.full((2, 3), 3.5))
        assert torch.equal(shard["b"], torch.tensor([1.0, 2.0, 3.0]))
        assert torch.equal(shard["up"], torch.zeros(4))
    with pytest.raises(ValueError):
        tmesh.reduce_gradients(mesh, grads[:2], like)


def test_sharded_aru_v1_visual_step_equals_the_unsharded_step(tmp_path):
    """Two shards of one visual graph each through the full ARU_v1 backbone
    (96 x 96 images): its logit, attention and up-path layers get no
    gradient on either shard, the L2 term's only on the first; the sharded
    step equals the unsharded one on both graphs, and moves no bias that
    no loss reaches."""
    paths = write_visual_graphs(str(tmp_path / "data"))
    batch = next(InputGNN(INPUT, seed=0).train_batches(paths, 2, 1))
    flags = {"weight_decay": 1e-6, "batch_size": 2}
    trainer = TrainerGNN(str(tmp_path / "port"), [], [], flags=flags, input_params=INPUT,
                         seed=0, device="cpu",
                         model=GraphRelation(15, 2, image_input=True,
                                             visual_backbone="ARU_v1"))
    trainer._build_model(batch)
    mesh = tmesh.make_mesh(["cpu"] * 2)
    replicas = tmesh.replicate(mesh, trainer.model)
    params = [dict(r.named_parameters()) for r in replicas]
    before = {k: v.detach().clone() for k, v in params[0].items()}
    opt_states = [trainer.optimizer.init(p) for p in params]
    loss = trainer._make_sharded_train_step(mesh, replicas)(
        params, opt_states, tmesh.shard_batch(mesh, batch))
    assert_replicas_equal(params)
    single = dict(trainer.model.named_parameters())
    single_loss = trainer._make_train_step()(single, trainer.optimizer.init(single),
                                            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(single_loss), rel=TOL)
    assert_leaves_close(gnn_flax_from_state_dict(params[0]), gnn_flax_from_state_dict(single))
    unreached = "visual.backbone.logit.bias"
    assert torch.equal(params[0][unreached], before[unreached])
    moved = "visual.backbone.logit.weight"      # by the weight decay alone
    assert not torch.equal(params[0][moved], before[moved])
