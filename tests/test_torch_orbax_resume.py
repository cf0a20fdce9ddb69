"""Training resumed on the port from the JAX package's orbax checkpoints, on
the CPU: both trainers (relation GNN and segmentation) write two epochs to
an orbax ``model_dir`` with the JAX package, the port resumes from a copy of
it (its parameters, optimizer state and EMA equal to the JAX restore, bit
for bit), and one further epoch on each side agrees within the existing
trainer parity tests' tolerances (1e-5; ``tests/test_torch_gnn_training.py``,
``tests/test_torch_seg_training.py``); optax's state for adam, nadam,
rmsprop, sgd and ``MultiSteps`` maps onto the port's optimizer, and one
more update agrees to 1e-6 of each parameter's scale
(``tests/test_torch_optimizer.py``); ``warmstart_params`` with a rename map
and an include pattern equals the JAX package's."""
import os
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("orbax.checkpoint")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import traverse_util  # noqa: E402

from citlab_as_tpu.models.gnn.model import GraphRelation as JGraphRelation  # noqa: E402
from citlab_as_tpu.train import checkpoint as jck  # noqa: E402
from citlab_as_tpu.train import input_pipeline as jinput  # noqa: E402
from citlab_as_tpu.train import optimizer as jopt  # noqa: E402
from citlab_as_tpu.train.trainer import TrainerGNN as JTrainerGNN  # noqa: E402
from citlab_as_tpu_torch.train import checkpoint as tck  # noqa: E402
from citlab_as_tpu_torch.train import optimizer as topt  # noqa: E402
from citlab_as_tpu_torch.train.trainer import TrainerGNN  # noqa: E402
from citlab_as_tpu_torch.weights import arunet_flax_from_state_dict, gnn_flax_from_state_dict  # noqa: E402
from tests.test_seg_training import gt_dir  # noqa: E402,F401  (fixture: JAX GT generator)
from tests.test_torch_gnn_training import TRAINER_FLAGS, TRAINER_INPUT, _graphs  # noqa: E402
from tests.test_training import _write_graph_jsons  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _assert_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g = got[k].detach().cpu().numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=f"{what} {k}")


def _assert_close(got, want, what):
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) / scale <= RTOL, f"{what} {k}"


def test_gnn_trainer_resumes_a_jax_model_dir(tmp_path):
    """The JAX trainer writes epochs 0 and 1 (weight decay, EMA, gradient
    accumulation); the port resumes from a copy of its model_dir with the
    JAX restore's state, and its third epoch equals the JAX trainer's own
    resumed third epoch."""
    graphs = _graphs(tmp_path / "data", 6)
    batch_np = next(jinput.InputGNN(TRAINER_INPUT, seed=0).train_batches(graphs[:4], 2, 1))
    init = _flat(jax.jit(JGraphRelation(num_classes=2).init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch_np.items()}))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JTrainerGNN(jdir, graphs[:4], graphs[4:], flags=dict(TRAINER_FLAGS, epochs=2),
                input_params=TRAINER_INPUT, seed=0).train()
    assert sorted(os.listdir(jdir)) == ["0", "1", "best", "current_epoch.info", "curves"]
    shutil.copytree(jdir, tdir)

    # resumed with nothing left to train: the live state is the restore
    resumed = TrainerGNN(tdir, graphs[:4], graphs[4:], flags=dict(TRAINER_FLAGS, epochs=2),
                         input_params=TRAINER_INPUT, seed=0, device="cpu",
                         init_params=init).train()
    assert resumed["history"] == []
    jstate, step = jck.restore_checkpoint(jdir, None)
    assert step == 1
    state = resumed["state"]
    _assert_equal(gnn_flax_from_state_dict(state["params"]), _flat(jstate["params"]), "params")
    _assert_equal(gnn_flax_from_state_dict(state["ema"]), _flat(jstate["ema"]), "ema")
    inner = jstate["opt_state"]["inner_opt_state"]
    opt = state["opt_state"]
    assert opt["count"] == int(inner[0]["count"]) == int(inner[1]["count"])
    assert opt["mini_step"] == int(jstate["opt_state"]["mini_step"])
    for slot, src in (("mu", inner[0]["mu"]), ("nu", inner[0]["nu"]),
                      ("acc_grads", jstate["opt_state"]["acc_grads"])):
        _assert_equal(gnn_flax_from_state_dict(opt[slot]), _flat(src), slot)

    want = JTrainerGNN(jdir, graphs[:4], graphs[4:], flags=dict(TRAINER_FLAGS, epochs=3),
                       input_params=TRAINER_INPUT, seed=0).train()
    got = TrainerGNN(tdir, graphs[:4], graphs[4:], flags=dict(TRAINER_FLAGS, epochs=3),
                     input_params=TRAINER_INPUT, seed=0, device="cpu", init_params=init).train()
    assert [r["epoch"] for r in got["history"]] == [r["epoch"] for r in want["history"]] == [2]
    for w, g in zip(want["history"], got["history"]):
        assert g["loss"] == pytest.approx(w["loss"], rel=RTOL)
        for k in w:
            assert g[k] == pytest.approx(w[k], abs=RTOL), (k, g, w)
    assert got["best_metrics"] == pytest.approx(want["best_metrics"], abs=RTOL)
    _assert_close(gnn_flax_from_state_dict(got["state"]["ema"]), _flat(want["state"]["ema"]),
                  "ema")
    _assert_close(gnn_flax_from_state_dict(got["state"]["params"]),
                  _flat(want["state"]["params"]), "params")


def test_segmentation_trainer_resumes_a_jax_model_dir(tmp_path, monkeypatch, gt_dir):  # noqa: F811
    from citlab_as_tpu.models.arunet import ARUNet as JARUNet
    from citlab_as_tpu.train import seg_trainer as jseg_trainer
    from citlab_as_tpu_torch.train import seg_trainer
    from tests.test_torch_seg_training import TINY, _jax_init
    flags = {"epochs": 2, "steps_per_epoch": 2, "batch_size": 1, "crop_size": (64, 64),
             "eval_steps": 1, "n_classes": 3, "ema_decay": 0.5}
    gp = TINY["RU"]
    monkeypatch.setattr(jseg_trainer, "ARUNet",
                        lambda **kw: JARUNet(**{**kw, "dtype": jnp.float32}))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jseg_trainer.TrainerSegmentation(jdir, gt_dir, eval_gt_dir=gt_dir, flags=flags,
                                     graph_params=gp).train()
    shutil.copytree(jdir, tdir)

    def port(epochs):
        return seg_trainer.TrainerSegmentation(
            tdir, gt_dir, eval_gt_dir=gt_dir, flags=dict(flags, epochs=epochs),
            graph_params=gp, device="cpu", compute_dtype=torch.float32,
            init_params=_jax_init("RU")).train()

    resumed = port(2)
    jstate, step = jck.restore_checkpoint(jdir, None)
    assert step == 1 and resumed["history"] == []
    _assert_equal(arunet_flax_from_state_dict(resumed["state"]["params"]),
                  _flat(jstate["params"]), "params")
    _assert_equal(arunet_flax_from_state_dict(resumed["state"]["ema"]),
                  _flat(jstate["ema"]), "ema")
    adam = jstate["opt_state"][0]
    assert resumed["state"]["opt_state"]["count"] == int(adam["count"])
    for slot in ("mu", "nu"):
        _assert_equal(arunet_flax_from_state_dict(resumed["state"]["opt_state"][slot]),
                      _flat(adam[slot]), slot)

    want = jseg_trainer.TrainerSegmentation(jdir, gt_dir, eval_gt_dir=gt_dir,
                                            flags=dict(flags, epochs=3), graph_params=gp).train()
    got = port(3)
    assert [r["epoch"] for r in got["history"]] == [r["epoch"] for r in want["history"]] == [2]
    for w, g in zip(want["history"], got["history"]):
        assert g["loss"] == pytest.approx(w["loss"], rel=RTOL), (g, w)
        assert g["accuracy"] == pytest.approx(w["accuracy"], abs=1e-4), (g, w)
    _assert_close(arunet_flax_from_state_dict(got["state"]["params"]),
                  _flat(want["state"]["params"]), "params")


@pytest.mark.parametrize("name,k", [("adam", 1), ("nadam", 1), ("rmsprop", 1), ("sgd", 1),
                                    ("adam", 3)])
def test_optax_state_maps_onto_the_port_optimizer(tmp_path, name, k):
    """Three updates with optax (the JAX package's ``build_optimizer``, a
    schedule that moves within the run), saved with its ``save_checkpoint``;
    the port's optimizer loads the orbax state through
    ``load_trainer_state`` and a fourth update equals optax's."""
    rng = np.random.default_rng(4)
    shapes = {"params/dense/kernel": (3, 4), "params/dense/bias": (4,),
              "params/out/kernel": (4, 2)}
    init = {p: rng.standard_normal(s).astype(np.float32) for p, s in shapes.items()}
    grads = [{p: rng.standard_normal(s).astype(np.float32) for p, s in shapes.items()}
             for _ in range(3 * k + k)]
    opt_params = {"optimizer": name, "learning_rate": 0.01, "learning_circle": 1,
                  "final_epochs": 2}
    jtx = jopt.build_optimizer(opt_params, 1, 4, "final_decay", k)

    def tree(flat):
        return traverse_util.unflatten_dict({tuple(p.split("/")): jnp.asarray(v)
                                             for p, v in flat.items()})

    params = tree(init)
    state = jtx.init(params)
    for g in grads[:3 * k]:
        updates, state = jtx.update(tree(g), state, params)
        params = optax.apply_updates(params, updates)
    jck.save_checkpoint(str(tmp_path), 3, {"params": params, "opt_state": state})

    tparams = {p: torch.zeros(s) for p, s in shapes.items()}
    ttx = topt.build_optimizer(opt_params, 1, 4, "final_decay", k)
    tstate = ttx.init(tparams)
    saved, step = tck.restore_checkpoint(str(tmp_path))
    assert step == 3

    def identity(flat):
        return {p: torch.as_tensor(np.asarray(v)) for p, v in flat.items()}

    tck.load_trainer_state(saved, tparams, tstate, None, identity)
    _assert_equal(tparams, _flat(params), "params")
    for g in grads[3 * k:]:
        updates, state = jtx.update(tree(g), state, params)
        params = optax.apply_updates(params, updates)
        ttx.step(tparams, {p: torch.as_tensor(v) for p, v in g.items()}, tstate)
    got = {p: t.numpy() for p, t in tparams.items()}
    want = _flat(params)
    for p in want:
        scale = max(float(np.abs(want[p]).max()), 1e-30)
        assert float(np.abs(got[p] - want[p]).max()) / scale <= 1e-6, (name, k, p)


def test_optimizer_mismatch_is_named(tmp_path):
    params = {"params": {"w": jnp.ones((2,))}}
    sgd = jopt.build_optimizer({"optimizer": "sgd"}, 1, 4)
    jck.save_checkpoint(str(tmp_path), 0, {"params": params, "opt_state": sgd.init(params)})
    saved, _ = tck.restore_checkpoint(str(tmp_path))
    tparams = {"params/w": torch.zeros(2)}
    adam = topt.build_optimizer({"optimizer": "adam"}, 1, 4)
    with pytest.raises(KeyError, match="another optimizer"):
        tck.load_trainer_state(saved, tparams, adam.init(tparams), None,
                               lambda f: {p: torch.as_tensor(np.asarray(v)) for p, v in f.items()})


def test_warmstart_from_a_jax_model_dir_equals_jax(tmp_path):
    """``warmstart_params`` from the committed relation-GNN run
    (``models_ckpt/gnn``, steps 28 and 29: params and adam's state) into a
    net whose classifier is renamed, with and without an include pattern:
    the port's result equals the JAX package's leaf for leaf."""
    src = os.path.join(REPO, "models_ckpt", "gnn")
    graphs = _write_graph_jsons(tmp_path, n_graphs=1)
    batch = next(iter(jinput.InputGNN().eval_batches(graphs)))[0]
    variables = jax.jit(JGraphRelation(num_classes=2).init)(
        jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in batch.items()})
    template = {"params": variables,
                "opt_state": jopt.build_optimizer({}, 1, 10).init(variables)}
    flat = traverse_util.flatten_dict(variables["params"], sep="/")
    renamed = {"params": {"params": traverse_util.unflatten_dict(
        {tuple(k.replace("Classification", "Head").split("/")): v + 1.0
         for k, v in flat.items()})}}
    rename = {r"Classification": "Head"}
    for include in (None, r"hidden_0|GraphLSTM1"):
        want = jck.warmstart_params(renamed, src, template, rename_map=rename,
                                    include_pattern=include)
        got = tck.warmstart_params(jax.tree_util.tree_map(np.asarray, renamed), src,
                                   rename_map=rename, include_pattern=include)
        wflat, gflat, before = _flat(want), tck.flatten(got), _flat(renamed)
        assert sorted(gflat) == sorted(wflat)
        for k in wflat:
            np.testing.assert_array_equal(gflat[k], wflat[k], err_msg=k)
        assert any(not np.array_equal(wflat[k], before[k]) for k in wflat)
        assert any(np.array_equal(wflat[k], before[k]) for k in wflat) == (include is not None)
