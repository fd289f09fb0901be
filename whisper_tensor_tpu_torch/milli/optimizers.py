"""Optimizer-step generation as milli ops.

Reference equivalent: generate_optimizer_ops (src/milli_graph/mod.rs:
1229-1432): SGD, SGDMomentum(+nesterov), Adam, AdamW (decoupled weight
decay) with optimizer state threaded as graph inputs/outputs and shared
beta^t bias-correction tensors (AdamShared, mod.rs:1434).

The port's copy of whisper_tensor_tpu/milli/optimizers.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .autodiff import TrainingMetadata
from .ir import MilliGraph, Phase
from .ops import CastLike, Constant, SimpleBinary, SimpleUnary

P = Phase.OPTIMIZER


class OptimizerKind(enum.Enum):
    SGD = "sgd"
    SGD_MOMENTUM = "sgd_momentum"
    ADAM = "adam"
    ADAMW = "adamw"


@dataclass
class OptimizerOptions:
    kind: OptimizerKind = OptimizerKind.ADAMW
    lr: float = 1e-3
    momentum: float = 0.9
    nesterov: bool = False
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


def generate_optimizer_ops(g: MilliGraph, params: Dict[str, int],
                           grads: Dict[str, int],
                           opts: OptimizerOptions,
                           meta: Optional[TrainingMetadata] = None
                           ) -> TrainingMetadata:
    """Append optimizer-update ops; marks outputs:
      new::<param>      updated parameter
      state::<s>::<p>   updated optimizer state (matching input state::...)
    Adam/AdamW take a scalar input 'step' (1-based) for bias correction
    (the reference's shared beta^t tensors)."""
    meta = meta or TrainingMetadata()

    def const_like(v: float, like: int) -> int:
        c = g.op1(Constant(np.asarray(v, dtype=np.float32)), phase=P)
        return g.op1(CastLike(), c, like, phase=P)

    def bin_(mode, a, b):
        return g.op1(SimpleBinary(mode), a, b, phase=P)

    step_in = None
    bc1 = bc2 = None
    if opts.kind in (OptimizerKind.ADAM, OptimizerKind.ADAMW):
        step_in = g.add_input("step")  # scalar f32, 1-based
        # shared bias corrections: 1 - beta^t  (computed once per step)
        b1 = g.op1(Constant(np.asarray(opts.beta1, dtype=np.float32)), phase=P)
        b2 = g.op1(Constant(np.asarray(opts.beta2, dtype=np.float32)), phase=P)
        one = g.op1(Constant(np.asarray(1.0, dtype=np.float32)), phase=P)
        from .ops import Pow

        bc1 = bin_("sub", one, g.op1(Pow(), b1, step_in, phase=P))
        bc2 = bin_("sub", one, g.op1(Pow(), b2, step_in, phase=P))

    for name, p_tid in params.items():
        grad = grads[name]
        if opts.kind is OptimizerKind.SGD:
            upd = bin_("mul", const_like(opts.lr, grad), grad)
            if opts.weight_decay:
                upd = bin_("add", upd, bin_("mul", const_like(
                    opts.lr * opts.weight_decay, p_tid), p_tid))
            new_p = bin_("sub", p_tid, upd)
        elif opts.kind is OptimizerKind.SGD_MOMENTUM:
            v_in = g.add_input(f"state::v::{name}")
            v_new = bin_("add", bin_("mul", const_like(opts.momentum, v_in), v_in),
                         grad)
            g.mark_output(f"state::v::{name}", v_new)
            meta.opt_state_in_to_out[f"state::v::{name}"] = f"state::v::{name}"
            eff = (bin_("add", grad, bin_("mul", const_like(opts.momentum, v_new), v_new))
                   if opts.nesterov else v_new)
            new_p = bin_("sub", p_tid, bin_("mul", const_like(opts.lr, eff), eff))
        else:  # adam / adamw
            m_in = g.add_input(f"state::m::{name}")
            v_in = g.add_input(f"state::v::{name}")
            gd = grad
            if opts.kind is OptimizerKind.ADAM and opts.weight_decay:
                gd = bin_("add", gd, bin_("mul", const_like(opts.weight_decay, p_tid), p_tid))
            m_new = bin_("add", bin_("mul", const_like(opts.beta1, m_in), m_in),
                         bin_("mul", const_like(1 - opts.beta1, gd), gd))
            g2 = bin_("mul", gd, gd)
            v_new = bin_("add", bin_("mul", const_like(opts.beta2, v_in), v_in),
                         bin_("mul", const_like(1 - opts.beta2, g2), g2))
            g.mark_output(f"state::m::{name}", m_new)
            g.mark_output(f"state::v::{name}", v_new)
            meta.opt_state_in_to_out[f"state::m::{name}"] = f"state::m::{name}"
            meta.opt_state_in_to_out[f"state::v::{name}"] = f"state::v::{name}"
            m_hat = bin_("div", m_new, g.op1(CastLike(), bc1, m_new, phase=P))
            v_hat = bin_("div", v_new, g.op1(CastLike(), bc2, v_new, phase=P))
            denom = bin_("add", g.op1(SimpleUnary("sqrt"), v_hat, phase=P),
                         const_like(opts.eps, v_hat))
            upd = bin_("div", m_hat, denom)
            if opts.kind is OptimizerKind.ADAMW and opts.weight_decay:
                upd = bin_("add", upd, bin_("mul", const_like(opts.weight_decay, p_tid), p_tid))
            new_p = bin_("sub", p_tid, bin_("mul", const_like(opts.lr, upd), upd))
        g.mark_output(f"new::{name}", new_p)
        meta.param_to_new[name] = f"new::{name}"
    return meta
