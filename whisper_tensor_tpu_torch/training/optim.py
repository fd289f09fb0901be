"""The optimizers of LMTrainer: optax's formulas in plain torch ops.

The JAX package's trainer (whisper_tensor_tpu/training/trainer.py:
117-137) builds its optimizer from optax: `adamw`, `adam`, `sgd` and
`sgd` with momentum 0.9, behind `clip_by_global_norm` when clipping is
asked for and inside `MultiSteps` for gradient accumulation, at a
constant rate or on `warmup_cosine_decay_schedule` / two joined
`linear_schedule`s. Each piece here is that transformation's update,
written out operation for operation in the same order and the same
types (a Python float scales a tensor in the tensor's type; bias
corrections, schedules and the global norm are f32), so a step here
matches optax's to f32 rounding.

A state is a flat list of tensors in the order `jax.tree.leaves` gives
for the matching optax state, so checkpoint files interchange between
the packages (training/checkpoint.py): a transformation owns a run of
that list; a per-parameter leaf set comes in sorted parameter-name
order, as a pytree dict's leaves do. For adamw at a constant rate the
list is count, mu by name, nu by name. Counters are int32 scalars.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


def _count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _increment(count: torch.Tensor) -> torch.Tensor:
    """optax's safe_increment: +1, saturating at the int32 maximum."""
    top = torch.iinfo(torch.int32).max
    return torch.where(count < top, count + 1, count)


# -- schedules (optax/_src/schedule.py, _join.py), f32 like optax's -------

def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule: polynomial_schedule with power 1."""
    if transition_steps <= 0:
        return lambda count: torch.full((), init_value, dtype=torch.float32,
                                        device=count.device)

    def schedule(count):
        c = torch.clamp(count, 0, transition_steps)
        frac = 1 - c.float() / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive "
                         f"decay_steps, got {decay_steps}")
    steps = float(decay_steps)

    def schedule(count):
        c = torch.minimum(count.float(), torch.tensor(steps,
                                                      device=count.device))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, sch in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, sch(count - boundary))
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule (exponent 1)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha)], [warmup_steps])


# -- gradient transformations ---------------------------------------------

class Transform:
    """One optax GradientTransformation: `init` gives its state leaves,
    `update` maps (updates, its leaves, params) to (updates, new
    leaves). Dicts are keyed by parameter name."""

    def n_leaves(self, names: Sequence[str]) -> int:
        return 0

    def init(self, params: Tensors) -> List[torch.Tensor]:
        return []

    def update(self, updates: Tensors, state: List[torch.Tensor],
               params: Tensors) -> Tuple[Tensors, List[torch.Tensor]]:
        raise NotImplementedError


def _zeros(params: Tensors) -> List[torch.Tensor]:
    return [torch.zeros_like(params[n]) for n in sorted(params)]


class ClipByGlobalNorm(Transform):
    """optax.clip_by_global_norm: where the global norm is at least
    max_norm, every update becomes (u / norm) * max_norm. norm_sq: the
    squared global norm of the updates where they are cut over a mesh
    (each element counted once; LMTrainer._global_sq), else their local
    sum of squares."""

    def __init__(self, max_norm: float,
                 norm_sq: Optional[Callable[[Tensors], torch.Tensor]] = None):
        self.max_norm = max_norm
        self.norm_sq = norm_sq

    def update(self, updates, state, params):
        names = sorted(updates)
        if self.norm_sq is not None:
            sq = self.norm_sq(updates)
        else:
            sq = 0
            for n in names:     # optax: sum(jnp.sum(|x|^2) for x in leaves)
                u = updates[n]
                sq = sq + torch.sum(u * u)
        norm = torch.sqrt(sq)
        keep = norm < self.max_norm
        return {n: torch.where(keep, updates[n],
                               (updates[n] / norm.to(updates[n].dtype))
                               * self.max_norm)
                for n in names}, state


class ScaleByAdam(Transform):
    """optax.scale_by_adam: leaves count, mu by name, nu by name."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def n_leaves(self, names):
        return 1 + 2 * len(names)

    def init(self, params):
        dev = next(iter(params.values())).device
        return [_count(dev)] + _zeros(params) + _zeros(params)

    def update(self, updates, state, params):
        names = sorted(updates)
        n = len(names)
        count, mu, nu = state[0], state[1:1 + n], state[1 + n:1 + 2 * n]
        mu = [(1 - self.b1) * updates[k] + self.b1 * m
              for k, m in zip(names, mu)]
        nu = [(1 - self.b2) * (updates[k] * updates[k]) + self.b2 * v
              for k, v in zip(names, nu)]
        count = _increment(count)
        c = count.float()
        bc1 = 1 - torch.pow(torch.tensor(self.b1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, device=c.device), c)
        out = {}
        for k, m, v in zip(names, mu, nu):
            m_hat = m / bc1.to(m.dtype)
            v_hat = v / bc2.to(v.dtype)
            out[k] = m_hat / (torch.sqrt(v_hat + self.eps_root) + self.eps)
        return out, [count] + mu + nu


class AddDecayedWeights(Transform):
    """optax.add_decayed_weights: u + weight_decay * p."""

    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def update(self, updates, state, params):
        return {k: u + self.weight_decay * params[k]
                for k, u in updates.items()}, state


class Trace(Transform):
    """optax.trace (heavy-ball momentum, not Nesterov): leaves the trace
    by name."""

    def __init__(self, decay: float):
        self.decay = decay

    def n_leaves(self, names):
        return len(names)

    def init(self, params):
        return _zeros(params)

    def update(self, updates, state, params):
        names = sorted(updates)
        new = [updates[k] + self.decay * t for k, t in zip(names, state)]
        return dict(zip(names, new)), new


class ScaleByLearningRate(Transform):
    """optax.scale_by_learning_rate: -lr * u at a constant rate (no
    leaves), or scale_by_schedule at -lr(count) cast to u's type (a
    count leaf)."""

    def __init__(self, lr: "float | Schedule"):
        self.lr = lr

    def n_leaves(self, names):
        return 1 if callable(self.lr) else 0

    def init(self, params):
        if callable(self.lr):
            return [_count(next(iter(params.values())).device)]
        return []

    def update(self, updates, state, params):
        if not callable(self.lr):
            step = -1 * self.lr
            return {k: step * u for k, u in updates.items()}, state
        count = state[0]
        step = -1 * self.lr(count)
        return ({k: step.to(u.dtype) * u for k, u in updates.items()},
                [_increment(count)])


class Chain(Transform):
    """optax.chain: the transformations in order, their leaves joined."""

    def __init__(self, *parts: Transform):
        self.parts = parts

    def n_leaves(self, names):
        return sum(p.n_leaves(names) for p in self.parts)

    def init(self, params):
        return [leaf for p in self.parts for leaf in p.init(params)]

    def update(self, updates, state, params):
        names = sorted(updates)
        out, at = [], 0
        for p in self.parts:
            n = p.n_leaves(names)
            updates, mine = p.update(updates, state[at:at + n], params)
            out += mine
            at += n
        return updates, out


class MultiSteps(Transform):
    """optax.MultiSteps (gradient mean, no skipping): leaves mini_step,
    gradient_step, the inner state's, then the running mean of the
    gradients by name. The inner update is applied on every k-th call;
    the others give zero updates."""

    def __init__(self, inner: Transform, every_k: int):
        self.inner, self.k = inner, every_k

    def n_leaves(self, names):
        return 2 + self.inner.n_leaves(names) + len(names)

    def init(self, params):
        dev = next(iter(params.values())).device
        return ([_count(dev), _count(dev)] + self.inner.init(params)
                + _zeros(params))

    def update(self, updates, state, params):
        names = sorted(updates)
        n_inner = self.inner.n_leaves(names)
        mini, grad_step = state[0], state[1]
        inner = state[2:2 + n_inner]
        acc = [a + (updates[k] - a) / (mini + 1).float()
               for k, a in zip(names, state[2 + n_inner:])]
        if int(mini) == self.k - 1:     # emit: the mean goes through
            upd, inner = self.inner.update(dict(zip(names, acc)), inner,
                                           params)
            return upd, ([(mini + 1) % self.k, _increment(grad_step)]
                         + inner + [torch.zeros_like(a) for a in acc])
        return ({k: torch.zeros_like(updates[k]) for k in names},
                [(mini + 1) % self.k, grad_step] + inner + acc)


def build_optimizer(optimizer: str, lr: float, weight_decay: float,
                    grad_clip: Optional[float], accum_steps: int,
                    lr_schedule: Optional[str], warmup_steps: int,
                    total_steps: int,
                    norm_sq: Optional[Callable[[Tensors], torch.Tensor]]
                    = None) -> Transform:
    """The optimizer the JAX trainer builds from the same arguments
    (trainer.py:117-137); norm_sq: ClipByGlobalNorm's, for updates cut
    over a mesh."""
    if lr_schedule is None:
        lr_arg: "float | Schedule" = lr
    elif lr_schedule == "warmup_cosine":
        lr_arg = warmup_cosine_decay_schedule(
            0.0, lr, max(warmup_steps, 1),
            max(total_steps, warmup_steps + 1))
    elif lr_schedule == "warmup_linear":
        lr_arg = join_schedules(
            [linear_schedule(0.0, lr, max(warmup_steps, 1)),
             linear_schedule(lr, 0.0, max(total_steps - warmup_steps, 1))],
            [max(warmup_steps, 1)])
    else:
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
    if optimizer == "adamw":
        tx: Transform = Chain(ScaleByAdam(), AddDecayedWeights(weight_decay),
                              ScaleByLearningRate(lr_arg))
    elif optimizer == "adam":
        tx = Chain(ScaleByAdam(), ScaleByLearningRate(lr_arg))
    elif optimizer == "sgd":
        tx = Chain(ScaleByLearningRate(lr_arg))
    elif optimizer == "sgd_momentum":
        tx = Chain(Trace(0.9), ScaleByLearningRate(lr_arg))
    else:
        raise ValueError(optimizer)
    if grad_clip:
        tx = Chain(ClipByGlobalNorm(grad_clip, norm_sq), tx)
    if accum_steps > 1:
        tx = MultiSteps(tx, accum_steps)
    return tx
