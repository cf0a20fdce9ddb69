"""The port's optimizers and schedules (``train/optimizer.py``) against
optax and the JAX package's schedules, on the CPU.

- every schedule at the steps around each of its boundaries (epoch and
  learning-circle edges, the start of the cooldown, the end of the warmup),
  to 1e-7 relative (both evaluate the same float32 expressions);
- adam, nadam, rmsprop and sgd under ``build_optimizer`` follow optax's
  parameter trajectory over 5 steps of random gradients, to 1e-6 relative
  to each parameter's scale, with a schedule that changes within the run;
- gradient accumulation (``MultiSteps``, k = 3) the same over 9 calls: the
  parameters move only on every third call, by the inner update of the
  running mean;
- the optimizer state survives ``state_dict`` / ``load_state_dict``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from citlab_as_tpu.train import optimizer as jopt
from citlab_as_tpu_torch.train import optimizer as topt

SCHED_RTOL = 1e-7
TRAJ_RTOL = 1e-6

SCHEDULES = {
    "decay": ("decay", dict(learning_rate=0.003, learning_circle=3,
                            lr_decay_rate=0.9), 7, 30),
    "final_decay": ("final_decay", dict(learning_rate=0.001, learning_circle=2,
                                        lr_decay_rate=0.97, decay_fraction=0.1,
                                        final_epochs=12), 5, 40),
    "final_decay_long": ("final_decay", dict(learning_rate=0.001), 256, 100),
    "warmup": ("warmup_final_decay", dict(learning_rate=0.002, learning_circle=3,
                                          lr_decay_rate=0.95, decay_fraction=0.2,
                                          final_epochs=10, warmup_epochs=6,
                                          warmup_factor=10), 4, 30),
}


def _boundary_steps(spe, epochs, p):
    edges = {0, 1}
    for e in range(epochs + 1):
        for d in (-1, 0, 1):
            edges.add(max(e * spe + d, 0))
    return sorted(edges)


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_equals_jax(name):
    kind, params, spe, epochs = SCHEDULES[name]
    j = jopt.build_schedule(kind, params, spe, epochs)
    t = topt.build_schedule(kind, params, spe, epochs)
    for step in _boundary_steps(spe, epochs, params):
        want = float(j(jnp.int32(step)))
        got = float(t(step))
        assert got == pytest.approx(want, rel=SCHED_RTOL, abs=0), (step, got, want)


def test_schedule_unknown_kind_raises():
    with pytest.raises(ValueError):
        topt.build_schedule("nope", {}, 10, 100)
    with pytest.raises(ValueError):
        topt.build_optimizer({"optimizer": "nope"}, 10, 100)


def _params(seed):
    rng = np.random.RandomState(seed)
    return {"a/kernel": rng.randn(4, 5).astype(np.float32),
            "a/bias": (0.1 * rng.randn(5)).astype(np.float32),
            "b/kernel": (0.01 * rng.randn(3, 3, 2)).astype(np.float32)}


def _grads(seed, step):
    rng = np.random.RandomState(1000 * seed + step)
    return {k: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
            for k, v in _params(seed).items()}


def _trajectories(name, accum, calls, seed=0):
    opt_params = {"optimizer": name, "learning_rate": 0.01, "learning_circle": 1,
                  "lr_decay_rate": 0.5}
    j = jopt.build_optimizer(opt_params, steps_per_epoch=2, epochs=100,
                             schedule_kind="decay", grad_accum_steps=accum)
    t = topt.build_optimizer(opt_params, steps_per_epoch=2, epochs=100,
                             schedule_kind="decay", grad_accum_steps=accum)
    jp = {k: jnp.asarray(v) for k, v in _params(seed).items()}
    tp = {k: torch.tensor(v) for k, v in _params(seed).items()}
    js, ts = j.init(jp), t.init(tp)
    out = []
    for step in range(calls):
        g = _grads(seed, step)
        upd, js = j.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        t.step(tp, {k: torch.tensor(v) for k, v in g.items()}, ts)
        out.append(({k: np.asarray(v) for k, v in jp.items()},
                    {k: v.numpy().copy() for k, v in tp.items()}))
    return out


def _assert_close(got, want, what):
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max()) / scale
        assert err <= TRAJ_RTOL, f"{what} {k}: {err:.3g}"


@pytest.mark.parametrize("name", ["adam", "nadam", "rmsprop", "sgd"])
def test_optimizer_trajectory_equals_optax(name):
    for step, (want, got) in enumerate(_trajectories(name, 1, 5)):
        _assert_close(got, want, f"{name} step {step}")


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_multisteps_trajectory_equals_optax(name):
    start = _params(0)
    for step, (want, got) in enumerate(_trajectories(name, 3, 9)):
        _assert_close(got, want, f"{name} k=3 call {step}")
        moved = any(not np.array_equal(got[k], start[k]) for k in start)
        assert moved == (step >= 2)


def test_optimizer_state_round_trip():
    t = topt.build_optimizer({"optimizer": "adam"}, 3, 10, grad_accum_steps=2)
    p = {k: torch.tensor(v) for k, v in _params(1).items()}
    s = t.init(p)
    for step in range(3):
        t.step(p, {k: torch.tensor(v) for k, v in _grads(1, step).items()}, s)
    saved = topt.Optimizer.state_dict(s)
    fresh = t.init({k: torch.zeros_like(v) for k, v in p.items()})
    topt.Optimizer.load_state_dict(fresh, saved)
    assert fresh["count"] == s["count"] == 1 and fresh["mini_step"] == 1
    for slot in ("mu", "nu", "acc_grads"):
        for k in p:
            assert torch.equal(fresh[slot][k], s[slot][k])
