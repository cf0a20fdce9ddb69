"""Optimizers + epoch-based LR schedules (port of
``citlab_as_tpu/train/optimizer.py``).

Schedules operate on the epoch index (global_step // steps_per_epoch), as
the JAX package's do (reference: gnn/model/graph_util/optimizer.py:9-171):

- decay: lr * decay_rate ^ floor(epoch / learning_circle) (staircase)
- final_decay: + cosine cooldown to decay_fraction over the final_epochs
- warmup_final_decay: + linear warmup from lr/warmup_factor over warmup_epochs

A schedule is a function of the update count evaluated on the host in
float32, in the JAX expressions' order, so that it gives optax's learning
rates.

The update rules are optax's (0.2.x), not ``torch.optim``'s, whose defaults
differ: ``optax.adam`` (Adam, bias-corrected, eps outside the root),
``optax.nadam`` (Adam with Nesterov momentum, no momentum-decay schedule),
``optax.rmsprop`` (decay 0.9, eps inside the square root, no bias
correction, second moment starting at 0) and ``optax.sgd`` (no momentum).
The schedule is evaluated at the count before its increment (the first
update uses ``schedule(0)``). Gradient accumulation is ``optax.MultiSteps``:
a running mean of k gradients (Welford's form), an inner update every k-th
call, zero updates in between; the inner count, and so the schedule, moves
once per k calls.

:class:`Optimizer` works on a dict of tensors (``{name: tensor}``) and
updates the parameters and its state in place. Its state is a dict of host
integers and per-parameter tensor dicts (``state_dict``/``load_state_dict``
give it as a flat dict for checkpoints).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

DEFAULT_OPTIMIZER_PARAMS: Dict[str, Any] = {
    "optimizer": "adam",
    "learning_rate": 0.001,
    "lr_decay_rate": 0.99,
    "learning_circle": 3,
    # final decay
    "final_epochs": 50,
    "decay_fraction": 0.1,
    # warmup
    "warmup_epochs": 10,
    "warmup_factor": 10,
}

_F = np.float32


def _epoch(step: int, steps_per_epoch: int) -> np.float32:
    """jnp.floor(step / steps_per_epoch) of an int32 step, in float32."""
    return np.floor(_F(np.int32(step)) / _F(steps_per_epoch))


@functools.cache
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.cosf.restype = ctypes.c_float
    lib.cosf.argtypes = [ctypes.c_float]
    return lib


def _cosf(x: np.float32) -> np.float32:
    """The C library's float32 cosine, which XLA's CPU backend calls for
    ``jnp.cos``; numpy's and torch's vectorised cosines differ from it by
    one ulp at some arguments."""
    return _F(_libm().cosf(float(x)))


def decay_schedule(learning_rate: float, steps_per_epoch: int,
                   learning_circle: int, lr_decay_rate: float):
    """Staircase exponential decay per learning_circle epochs."""
    def schedule(step: int) -> np.float32:
        epoch = _epoch(step, steps_per_epoch)
        return _F(learning_rate) * _F(lr_decay_rate) ** np.floor(
            epoch / _F(learning_circle))
    return schedule


def final_decay_schedule(learning_rate: float, steps_per_epoch: int,
                         learning_circle: int, lr_decay_rate: float,
                         decay_fraction: float, epochs: int, final_epochs: int,
                         delay: int = 0):
    """Staircase decay with cosine cooldown over the final epochs
    (optimizer.py:107-135)."""
    lr, rate, frac = _F(learning_rate), _F(lr_decay_rate), _F(decay_fraction)
    keep = _F(1 - decay_fraction)

    def schedule(step: int) -> np.float32:
        epoch = _epoch(step, steps_per_epoch)
        completed = (epoch - _F(delay)) / _F(learning_circle)
        lam = lr if epoch <= delay else lr * rate ** np.floor(completed)
        if epoch <= epochs - final_epochs:
            return lam
        cos = _cosf((epoch - _F(epochs) + _F(final_epochs)) / _F(final_epochs)
                     * _F(math.pi))
        return lam * (frac + keep * (_F(0.5) + _F(0.5) * cos))
    return schedule


def warmup_final_decay_schedule(learning_rate: float, steps_per_epoch: int,
                                learning_circle: int, lr_decay_rate: float,
                                decay_fraction: float, epochs: int,
                                final_epochs: int, warmup_epochs: int,
                                warmup_factor: float):
    """Linear warmup from lr/warmup_factor, then final-decay
    (optimizer.py:138-171)."""
    base = final_decay_schedule(
        learning_rate, steps_per_epoch, learning_circle, lr_decay_rate,
        decay_fraction, epochs, final_epochs, delay=warmup_epochs)
    lr = _F(learning_rate)
    start = learning_rate / warmup_factor
    slope = _F((learning_rate - start) / warmup_epochs)

    def schedule(step: int) -> np.float32:
        epoch = _epoch(step, steps_per_epoch)
        if epoch < warmup_epochs:
            warm = _F(start) + slope * epoch
            # during warmup the base schedule holds lr constant (epoch <=
            # delay), so scale its output by warm/learning_rate
            return base(step) * warm / lr
        return base(step)
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], np.float32]:
    """optax's ``cosine_decay_schedule`` (exponent 1): a function of the
    update count, init_value * ((1 - alpha) * 0.5 * (1 + cos(pi * t / T))
    + alpha) with t clipped to T, in float32 in optax's order."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive decay_steps, "
                         f"got {decay_steps}")
    steps = _F(decay_steps)

    def schedule(count: int) -> np.float32:
        t = np.minimum(_F(np.int32(count)), steps)
        cosine = _F(0.5) * (_F(1) + _cosf(_F(math.pi) * t / steps))
        return _F(init_value) * (_F(1 - alpha) * cosine + _F(alpha))
    return schedule


def build_schedule(kind: str, params: Dict[str, Any], steps_per_epoch: int,
                   epochs: int) -> Callable[[int], np.float32]:
    """kind in ('decay', 'final_decay', 'warmup_final_decay')."""
    p = dict(DEFAULT_OPTIMIZER_PARAMS)
    p.update(params or {})
    if kind == "decay":
        return decay_schedule(p["learning_rate"], steps_per_epoch,
                              p["learning_circle"], p["lr_decay_rate"])
    if kind == "final_decay":
        return final_decay_schedule(
            p["learning_rate"], steps_per_epoch, p["learning_circle"],
            p["lr_decay_rate"], p["decay_fraction"], epochs, p["final_epochs"])
    if kind == "warmup_final_decay":
        return warmup_final_decay_schedule(
            p["learning_rate"], steps_per_epoch, p["learning_circle"],
            p["lr_decay_rate"], p["decay_fraction"], epochs, p["final_epochs"],
            p["warmup_epochs"], p["warmup_factor"])
    raise ValueError(f"Unknown schedule kind '{kind}'")


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in float32 (optax's ``bias_correction``)."""
    return float(_F(1) - _F(decay) ** _F(count))


def _c(x: float) -> float:
    """A python float holding float32(x), the weak-typed constant's value."""
    return float(_F(x))


class Optimizer:
    """optax's adam | nadam | rmsprop | sgd with an epoch schedule, optionally
    wrapped in ``MultiSteps`` (``grad_accum_steps`` > 1), on a dict of
    tensors.

    ``init(params)`` returns the state; ``step(params, grads, state)``
    applies one update in place (``params[k] += update[k]``; a
    ``MultiSteps`` mini-step that only accumulates leaves them as they
    are)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8
    RMS_DECAY = 0.9

    def __init__(self, name: str, schedule: Callable[[int], np.float32],
                 grad_accum_steps: int = 1):
        if name not in ("adam", "nadam", "rmsprop", "sgd"):
            raise ValueError(f"Unknown optimizer '{name}'")
        self.name = name
        self.schedule = schedule
        self.k = int(grad_accum_steps)

    # ------------------------------------------------------------ state
    def _slots(self):
        return {"adam": ("mu", "nu"), "nadam": ("mu", "nu"),
                "rmsprop": ("nu",), "sgd": ()}[self.name]

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        state: Dict[str, Any] = {"count": 0}
        for slot in self._slots():
            state[slot] = {k: torch.zeros_like(v) for k, v in params.items()}
        if self.k > 1:
            state["mini_step"] = 0
            state["acc_grads"] = {k: torch.zeros_like(v) for k, v in params.items()}
        return state

    # ------------------------------------------------------------ update
    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: Dict[str, Any]) -> None:
        if self.k == 1:
            self._update(params, grads, state)
            return
        n = state["mini_step"]
        acc = state["acc_grads"]
        for key, g in grads.items():
            # Welford mean: acc + (g - acc) / (n + 1)
            acc[key].add_((g - acc[key]) / float(n + 1))
        if n < self.k - 1:
            state["mini_step"] = n + 1
            return
        self._update(params, acc, state)
        state["mini_step"] = 0
        for t in acc.values():
            t.zero_()

    def _update(self, params, grads, state) -> None:
        count = state["count"]
        neg_lr = -float(_F(self.schedule(count)))
        b1, b2, eps = self.B1, self.B2, self.EPS
        if self.name in ("adam", "nadam"):
            c1, c2 = _c(1 - b1), _c(1 - b2)
            bc1 = _bias_correction(b1, count + 1)
            bc2 = _bias_correction(b2, count + 1)
            bc1_next = _bias_correction(b1, count + 2)
            for key, g in grads.items():
                mu, nu = state["mu"][key], state["nu"][key]
                mu.copy_(g * c1 + mu * _c(b1))
                nu.copy_(g * g * c2 + nu * _c(b2))
                if self.name == "nadam":
                    mu_hat = (mu / bc1_next) * _c(b1) + (g / bc1) * c1
                else:
                    mu_hat = mu / bc1
                upd = mu_hat / (torch.sqrt(nu / bc2) + _c(eps))
                params[key].add_(upd * neg_lr)
        elif self.name == "rmsprop":
            d = self.RMS_DECAY
            for key, g in grads.items():
                nu = state["nu"][key]
                nu.copy_(g * g * _c(1 - d) + nu * _c(d))
                upd = torch.rsqrt(nu + _c(eps)) * g
                params[key].add_(upd * neg_lr)
        else:
            for key, g in grads.items():
                params[key].add_(g * neg_lr)
        state["count"] = count + 1

    # ------------------------------------------------------------ checkpoints
    @staticmethod
    def state_dict(state: Dict[str, Any]) -> Dict[str, Any]:
        """Nested dict of numpy arrays: counters as int32 scalars, per-
        parameter slots as ``{slot: {name: array}}``."""
        out: Dict[str, Any] = {}
        for key, val in state.items():
            if isinstance(val, dict):
                out[key] = {k: v.detach().cpu().numpy() for k, v in val.items()}
            else:
                out[key] = np.int32(val)
        return out

    @staticmethod
    def load_state_dict(state: Dict[str, Any], saved: Dict[str, Any]) -> None:
        """Copy ``saved`` (as :meth:`state_dict` gives it) into ``state`` in
        place, keeping each tensor's device and dtype."""
        for key, val in state.items():
            if isinstance(val, dict):
                for k, t in val.items():
                    t.copy_(torch.as_tensor(np.asarray(saved[key][k])))
            else:
                state[key] = int(np.asarray(saved[key]))


def adam(schedule: Callable[[int], np.float32]) -> Optimizer:
    """``optax.adam(schedule)`` over a step schedule (the separator recipe's
    ``adam(cosine_decay_schedule(...))``)."""
    return Optimizer("adam", schedule)


def build_optimizer(params: Optional[Dict[str, Any]] = None,
                    steps_per_epoch: int = 1, epochs: int = 200,
                    schedule_kind: str = "final_decay",
                    grad_accum_steps: int = 1) -> Optimizer:
    """Optimizer factory: adam | nadam | rmsprop | sgd with an epoch
    schedule; optional gradient accumulation (``optax.MultiSteps``)."""
    p = dict(DEFAULT_OPTIMIZER_PARAMS)
    p.update(params or {})
    schedule = build_schedule(schedule_kind, p, steps_per_epoch, epochs)
    return Optimizer(p["optimizer"], schedule, grad_accum_steps)
