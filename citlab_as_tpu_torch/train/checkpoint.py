"""Checkpointing, EMA, best-model export, epoch resume, warm start (port of
``citlab_as_tpu/train/checkpoint.py``).

Reference analogs: tf.estimator checkpoints + ``current_epoch.info`` resume
(trainer_base.py:228-264), best-model copies per metric (export_best,
trainer_base.py:169-189, gnn/io.py:45-66), EMA shadow weights
(model_base.py:202-211), warm start with variable renames
(util/warmstart.py:8-97), and the epoch loop both trainers run on them
(:func:`run_epochs`).

Saving writes the JAX package's format: an orbax checkpoint per directory
(``<ckpt_dir>/<step>/``, ``<ckpt_dir>/best/<metric>/``; ``train/orbax.py``,
no orbax needed) holding the tree the JAX trainers save, so the JAX
package restores, resumes, warm-starts and freezes a port run's
``--model_dir``. :func:`trainer_state` gives that tree: ``{"params":
variables, "opt_state": <optax state>, "ema": variables}`` with the flax
nesting of the variables and optax's state of the chain
``citlab_as_tpu/train/optimizer.py`` builds (``ScaleByAdamState``,
``ScaleByRmsState``, ``EmptyState``, ``ScaleByScheduleState``, inside
``MultiStepsState`` under gradient accumulation); a best export is the
variables alone. Reading takes an orbax checkpoint, the JAX package's or
the port's, or the ``checkpoint.npz`` that earlier port runs wrote; the
optax state maps back onto the port's :class:`Optimizer` state for adam,
nadam, rmsprop and sgd. The trainers name every parameter by its flat flax
path (``params/featMapG/unet_down_0/conv1/conv/kernel``, ``weights.py``),
so renames and include patterns read as in the JAX package;
both predictors load a best export's directory or a model directory's
newest step.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from citlab_as_tpu_torch.train import orbax
from citlab_as_tpu_torch.train.optimizer import Optimizer

logger = logging.getLogger(__name__)

#: the single file of an earlier port run's checkpoint directory (read only)
CHECKPOINT_FILE = "checkpoint.npz"


# ---------------------------------------------------------------- EMA

def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.999) -> Dict[str, torch.Tensor]:
    """shadow = decay * shadow + (1 - decay) * params, in place (the shadow
    dict is returned)."""
    for k, e in ema_params.items():
        e.copy_(decay * e + (1.0 - decay) * params[k].detach())
    return ema_params


# ---------------------------------------------------------------- flat trees

def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> ``{path: ndarray}`` with ``/``-joined keys; a list or
    tuple's items are named ``[i]``, as ``jax.tree_util`` names them, and a
    bf16 tensor stays a (host) tensor, as numpy has no bfloat16."""
    out: Dict[str, np.ndarray] = {}
    items = (tree.items() if isinstance(tree, dict)
             else ((f"[{i}]", v) for i, v in enumerate(tree)))
    for key, val in items:
        path = f"{prefix}{key}"
        if isinstance(val, (dict, list, tuple)):
            out.update(flatten(val, path + "/"))
        elif isinstance(val, torch.Tensor):
            val = val.detach().cpu()
            out[path] = val if val.dtype == torch.bfloat16 else val.numpy()
        elif val is not None:
            out[path] = np.asarray(val)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, val in flat.items():
        *scopes, leaf = path.split("/")
        node = out
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = val
    return out


def _read(path: str, template=None):
    """The state saved in directory ``path``: its orbax checkpoint (the tree
    orbax restores, sequences as lists, where no template is given) or an
    earlier port run's ``checkpoint.npz``."""
    if os.path.isfile(os.path.join(path, CHECKPOINT_FILE)):
        with np.load(os.path.join(path, CHECKPOINT_FILE)) as data:
            flat = {k: data[k] for k in data.files}
        if template is None:
            return unflatten(flat)
    elif orbax.is_orbax_checkpoint(path):
        tree = orbax.restore(path)
        if template is None:
            return tree
        flat = flatten(tree)
    else:
        raise FileNotFoundError(f"{path} holds neither {CHECKPOINT_FILE} nor an "
                                "orbax checkpoint")
    want = flatten(template)
    missing = sorted(set(want) - set(flat))
    if missing:
        raise KeyError(f"checkpoint {path} lacks {missing[:5]}")
    for k, v in want.items():
        if flat[k].shape != v.shape:
            raise ValueError(f"checkpoint {path}: {k} has shape {flat[k].shape}, "
                             f"the template {v.shape}")
    return unflatten({k: flat[k] for k in want})


# ---------------------------------------------------------------- numbered

def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    """Save ``state`` as an orbax checkpoint under <ckpt_dir>/<step>; keep
    the 2 newest steps."""
    path = orbax.save(os.path.join(ckpt_dir, str(step)), state)
    _prune_checkpoints(ckpt_dir, keep=2)
    return path


def restore_checkpoint(ckpt_dir: str, state_template=None,
                       step: Optional[int] = None):
    """Restore the given (or latest) step as a nested dict of numpy arrays;
    returns (state, step) or (template, None) when no checkpoint exists.
    With a template, only its paths are read and their shapes must match."""
    if step is None:
        step = latest_checkpoint_step(ckpt_dir)
        if step is None:
            return state_template, None
    return _read(os.path.join(ckpt_dir, str(step)), state_template), step


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if re.fullmatch(r"\d+", d)]
    return max(steps) if steps else None


def _prune_checkpoints(ckpt_dir: str, keep: int = 2) -> None:
    """keep_checkpoint_max=2 semantics (trainer_base.py:228-237)."""
    steps = sorted(int(d) for d in os.listdir(ckpt_dir) if re.fullmatch(r"\d+", d))
    for step in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(step)), ignore_errors=True)


def checkpoint_variables(path: str, bare_state_ok: bool = True
                         ) -> Tuple[Dict[str, Any], str]:
    """Flat variables (``params/...`` flax paths) of ``path`` and the path
    read, as the JAX package's predictors and exporter take them
    (``citlab_as_tpu/train/export.py``:112-139, ``inference.py``:51-58 and
    :227-240): an ``.npz`` file (``models_ckpt_torch/``); else the newest
    numbered step under the directory or, where it has none, the directory
    itself, each an orbax checkpoint or an earlier port run's
    ``checkpoint.npz``. A trainer's state (``{params, opt_state, ...}``, or
    a ``params`` subtree that holds ``params``) gives its ``params``
    subtree, a best export or converted weights the variables themselves.
    A directory with no numbered step that holds a trainer's state (a
    step's own directory) is refused unless ``bare_state_ok``, as the JAX
    ``SegmentationPredictor`` refuses it; a best export is always read."""
    if os.path.isfile(path):
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        target, bare = path, False
    else:
        step = latest_checkpoint_step(path)
        target = path if step is None else os.path.join(path, str(step))
        flat, bare = flatten(_read(target)), step is None
    if any(k.startswith(("opt_state/", "params/params/")) for k in flat):
        if bare and not bare_state_ok:
            raise FileNotFoundError(f"No checkpoint found in {path}: a trainer's step "
                                    "is read from its model directory")
        flat = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    return flat, os.path.abspath(target)


# ---------------------------------------------------------------- best export

_LOWER_IS_BETTER = ("loss",)


def is_better(metric_name: str, new: float, best: Optional[float]) -> bool:
    """Direction-aware best-metric comparison: 'loss' improves downward,
    everything else (accuracy/precision/recall/f1/auc_*) upward."""
    if best is None:
        return True
    if any(metric_name == m or metric_name.endswith("_" + m)
           for m in _LOWER_IS_BETTER):
        return new < best
    return new > best


def best_path(ckpt_dir: str, metric_name: str) -> str:
    """The directory that :func:`export_best` writes for ``metric_name``."""
    return os.path.join(os.path.abspath(ckpt_dir), "best", metric_name)


def export_best(ckpt_dir: str, metric_name: str, state) -> str:
    """Save ``state`` (the JAX trainers save the evaluated variables,
    ``{"params": {...}}``) as best/<metric>/ (trainer_base.py:169-189)."""
    return orbax.save(best_path(ckpt_dir, metric_name), state)


def restore_best(ckpt_dir: str, metric_name: str, state_template=None):
    return _read(best_path(ckpt_dir, metric_name), state_template)


# ---------------------------------------------------------------- trainer state

class ScaleByAdamState(NamedTuple):
    """optax's state of ``scale_by_adam`` (adam and nadam)."""
    count: Any
    mu: Any
    nu: Any


class ScaleByRmsState(NamedTuple):
    """optax's state of ``scale_by_rms`` (rmsprop)."""
    nu: Any


class EmptyState(NamedTuple):
    """optax's state of a stateless transformation (sgd's ``identity``)."""


class ScaleByScheduleState(NamedTuple):
    """optax's state of ``scale_by_learning_rate`` with a schedule."""
    count: Any


class MultiStepsState(NamedTuple):
    """optax's state of ``MultiSteps`` (gradient accumulation)."""
    mini_step: Any
    gradient_step: Any
    inner_opt_state: Any
    acc_grads: Any
    skip_state: Any


def variables(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Flat flax paths (``params/featMapG/...``) -> the variables dict flax
    nests them in (``{"params": {"featMapG": {...}}}``), every leaf a tensor
    (sharing a numpy leaf's memory): a JAX trainer holds ``jax.Array``s and
    saves them so."""
    return unflatten({k: torch.as_tensor(v) for k, v in flat.items()})


def _count(value) -> torch.Tensor:
    return torch.tensor(int(value), dtype=torch.int32)


def _optax_state(opt_state: Dict[str, Any], to_flax) -> Any:
    """The port's optimizer state as optax's state of the chain the JAX
    package builds (``citlab_as_tpu/train/optimizer.py``:115-126), told
    apart by the slots the state holds: adam and nadam ``(ScaleByAdamState,
    ScaleByScheduleState)``, rmsprop ``(ScaleByRmsState,
    ScaleByScheduleState, EmptyState)``, sgd ``(EmptyState,
    ScaleByScheduleState)``; inside ``MultiStepsState`` where gradients
    accumulate."""
    count = opt_state["count"]
    schedule = ScaleByScheduleState(_count(count))
    if "mu" in opt_state:
        chain = (ScaleByAdamState(_count(count), variables(to_flax(opt_state["mu"])),
                                  variables(to_flax(opt_state["nu"]))), schedule)
    elif "nu" in opt_state:
        # optax.rmsprop closes its chain with momentum's identity
        chain = (ScaleByRmsState(variables(to_flax(opt_state["nu"]))), schedule, EmptyState())
    else:
        chain = (EmptyState(), schedule)
    if "mini_step" not in opt_state:
        return chain
    return MultiStepsState(_count(opt_state["mini_step"]), _count(count), chain,
                           variables(to_flax(opt_state["acc_grads"])), ())


def trainer_state(params, opt_state, ema, to_flax) -> Dict[str, Any]:
    """A trainer's live tensors as the tree the JAX trainers checkpoint
    (``citlab_as_tpu/train/trainer.py``:83-85, ``seg_trainer.py``:80):
    ``{"params": variables, "opt_state": optax state, "ema": variables}``,
    every per-parameter tensor placed by the flat flax path ``to_flax``
    gives it (``weights.*_flax_from_state_dict``)."""
    state: Dict[str, Any] = {"params": variables(to_flax(params)),
                             "opt_state": _optax_state(opt_state, to_flax)}
    if ema is not None:
        state["ema"] = variables(to_flax(ema))
    return state


def _optax_opt_state(opt) -> Dict[str, Any]:
    """An optax ``opt_state`` as orbax restores it (the chain's tuple as a
    list, optionally inside ``MultiStepsState``) -> the port's optimizer
    state layout: ``count`` (the chain's update count: adam's and the
    schedule's, and ``MultiSteps``' ``gradient_step``, which optax moves
    together), ``mu`` / ``nu`` (adam's or rmsprop's moments, flax paths)
    and, under ``MultiSteps``, ``mini_step`` and ``acc_grads``."""
    out: Dict[str, Any] = {}
    chain = opt
    counts = []
    if isinstance(opt, dict) and "inner_opt_state" in opt:
        out["mini_step"] = opt["mini_step"]
        out["acc_grads"] = opt["acc_grads"]
        counts.append(int(np.asarray(opt["gradient_step"])))
        chain = opt["inner_opt_state"]
    if not isinstance(chain, list):
        raise ValueError("opt_state is not an optax chain's state")
    for part in chain:
        if isinstance(part, dict):
            if "count" in part:
                counts.append(int(np.asarray(part["count"])))
            for slot in ("mu", "nu"):
                if slot in part:
                    out[slot] = part[slot]
    if not counts or len(set(counts)) != 1:
        raise ValueError(f"opt_state's update counts {counts} do not give one count")
    out["count"] = np.int32(counts[0])
    return out


def load_trainer_state(saved, params, opt_state, ema, from_flax) -> None:
    """Copy a restored :func:`trainer_state` (nested numpy dicts) into the
    live tensors in place; ``from_flax`` maps flat flax paths back to
    parameter names. A JAX trainer's state (an optax ``opt_state``, read
    from its orbax checkpoint) is mapped onto the port's layout first."""
    saved = dict(saved)
    if not isinstance(saved.get("opt_state"), dict) or "count" not in saved["opt_state"]:
        saved["opt_state"] = _optax_opt_state(saved.get("opt_state"))
    missing = sorted(k for k in opt_state if k not in saved["opt_state"])
    if missing:
        raise KeyError(f"the checkpoint's optimizer state lacks {missing} (another "
                       "optimizer or gradient accumulation?)")
    flat = flatten(saved)

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}

    def copy_into(dst, src):
        with torch.no_grad():
            for k, t in dst.items():
                t.copy_(src[k].to(t.dtype))

    copy_into(params, from_flax(sub("params/")))
    opt = {}
    for key, val in opt_state.items():
        opt[key] = ({k: v.numpy() for k, v in from_flax(sub(f"opt_state/{key}/")).items()}
                    if isinstance(val, dict) else flat[f"opt_state/{key}"])
    Optimizer.load_state_dict(opt_state, opt)
    if ema is not None:
        copy_into(ema, from_flax(sub("ema/")))


# ---------------------------------------------------------------- epoch info

def write_epoch_info(model_dir: str, epoch: int, extra: Optional[Dict] = None) -> None:
    """current_epoch.info resume file (trainer_base.py:254-264)."""
    info = {"current_epoch": epoch}
    if extra:
        info.update(extra)
    with open(os.path.join(model_dir, "current_epoch.info"), "w") as f:
        json.dump(info, f)


def read_epoch_info(model_dir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(model_dir, "current_epoch.info")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------- epoch loop

def run_epochs(model_dir: str, flags: Dict[str, Any], params, opt_state, ema,
               to_flax: Callable, from_flax: Callable,
               train_batches: Callable[[], Iterator],
               train_step: Callable[[Any], torch.Tensor],
               evaluate: Optional[Callable[[int, Any], Dict[str, float]]] = None,
               name: str = "") -> Dict[str, Any]:
    """The epoch loop both trainers share (``citlab_as_tpu/train/trainer.py``
    :146 and ``seg_trainer.py``:75 are one contract): resume from
    ``current_epoch.info`` and the newest checkpoint, seeding
    ``best_metrics`` only when a checkpoint restored (stale info without
    checkpoints must not suppress a fresh run's exports); per epoch
    ``train_step(batch)`` over ``train_batches()`` with the EMA update
    after each step, ``evaluate(epoch, ema)`` every ``eval_every_n`` epochs
    (``ema`` None: the live parameters), a best export per metric of the
    evaluated parameters, early stopping after ``early_stopping_patience``
    evals without a gain (that epoch writes no checkpoint), a checkpoint and
    ``current_epoch.info``. ``params``, ``opt_state`` and ``ema`` are the
    dicts ``train_step`` updates in place. Returns ``{"best_metrics",
    "history", "timings"}``, ``timings`` the seconds of host batches, train
    steps (up to each loss readback), eval and checkpoints."""
    info = read_epoch_info(model_dir)
    start_epoch, resumed = 0, False
    if info:
        saved, restored = restore_checkpoint(model_dir)
        if restored is not None:
            load_trainer_state(saved, params, opt_state, ema, from_flax)
            start_epoch, resumed = info["current_epoch"], True
            logger.info("Resuming %s training from epoch %d", name, start_epoch)
    best: Dict[str, float] = dict(info.get("best_metrics", {})) if resumed else {}
    ema_decay = flags["ema_decay"]
    timings = {"batches": 0.0, "steps": 0.0, "eval": 0.0, "checkpoint": 0.0}
    history: List[Dict[str, float]] = []
    bad_evals = 0
    for epoch in range(start_epoch, flags["epochs"]):
        t0 = time.time()
        losses = []
        batches = train_batches()
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            timings["batches"] += time.perf_counter() - t
            if batch is None:
                break
            t = time.perf_counter()
            loss = train_step(batch)
            if ema is not None:
                ema_update(ema, params, ema_decay)
            losses.append(float(loss))
            timings["steps"] += time.perf_counter() - t
        record = {"epoch": epoch, "loss": float(np.mean(losses))}
        logger.info("%s epoch %d: loss=%.4f (%.1fs)", name, epoch, record["loss"],
                    time.time() - t0)

        if evaluate is not None and (epoch + 1) % flags["eval_every_n"] == 0:
            t = time.perf_counter()
            metrics = evaluate(epoch, ema)
            record.update(metrics)
            timings["eval"] += time.perf_counter() - t
            logger.info("%s epoch %d eval: %s", name, epoch, metrics)
            improved = False
            for metric in flags["best_export_metrics"]:
                if metric in metrics and is_better(metric, metrics[metric], best.get(metric)):
                    best[metric] = metrics[metric]
                    export_best(model_dir, metric,
                                variables(to_flax(ema if ema is not None else params)))
                    improved = True
            if flags["early_stopping_patience"] > 0:
                bad_evals = 0 if improved else bad_evals + 1
                if bad_evals >= flags["early_stopping_patience"]:
                    logger.info("Early stopping at epoch %d", epoch)
                    history.append(record)
                    break
        history.append(record)
        t = time.perf_counter()
        save_checkpoint(model_dir, epoch, trainer_state(params, opt_state, ema, to_flax))
        write_epoch_info(model_dir, epoch + 1, extra={"best_metrics": best})
        timings["checkpoint"] += time.perf_counter() - t
    return {"best_metrics": best, "history": history, "timings": timings}


# ---------------------------------------------------------------- warmstart

def warmstart_params(params, ckpt_dir: str, template=None,
                     rename_map: Optional[Dict[str, str]] = None,
                     include_pattern: Optional[str] = None):
    """Initialize matching leaves of ``params`` (a nested or flat dict of
    arrays or tensors) from the latest checkpoint in ``ckpt_dir``, with
    optional regex renames applied to source paths (util/warmstart.py:8-97).
    A leaf is taken when its renamed source path equals its path, the
    shapes agree and ``include_pattern`` (if given) matches the path;
    leaves missing from the source keep their fresh values. Tensor leaves
    keep their device and dtype."""
    source, _ = restore_checkpoint(ckpt_dir, template)
    src_flat = flatten(source)
    if rename_map:
        renamed = {}
        for name, leaf in src_flat.items():
            new_name = name
            for pattern, repl in rename_map.items():
                new_name = re.sub(pattern, repl, new_name)
            renamed[new_name] = leaf
        src_flat = renamed

    include_re = re.compile(include_pattern) if include_pattern else None

    def walk(tree, prefix):
        out = {}
        for key, leaf in tree.items():
            name = f"{prefix}{key}"
            if isinstance(leaf, dict):
                out[key] = walk(leaf, name + "/")
                continue
            candidate = src_flat.get(name)
            usable = (candidate is not None
                      and tuple(np.shape(candidate)) == tuple(np.shape(leaf))
                      and (include_re is None or include_re.search(name)))
            if not usable:
                out[key] = leaf
            elif isinstance(leaf, torch.Tensor):
                out[key] = torch.as_tensor(candidate).to(leaf.device, leaf.dtype)
            else:
                out[key] = candidate
        return out

    return walk(params, "")
