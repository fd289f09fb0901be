"""RandomNormalLike and its PyTorch lowering.

The class is the port's copy of whisper_tensor_tpu/milli/ops/random.py
(numpy `eval`; no `to_jax`). The lowering draws from torch's generator on
the device, seeded from the op's seed: like the reference's XLA path it
matches the oracle in distribution, not value for value (the corpus
checks it by moments, tests/conformance/test_random.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...dtype import DType, from_torch, to_torch
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering


@dataclass
class RandomNormalLike(MilliOp):
    mean: float = 0.0
    scale: float = 1.0
    seed: Optional[int] = None
    dtype: Optional[DType] = None
    KIND = "RandomNormalLike"

    def eval(self, inputs):
        x = inputs[0]
        dt = (self.dtype or DType.from_numpy(x.dtype)).to_numpy()
        rng = np.random.default_rng(None if self.seed is None else int(self.seed))
        return [rng.normal(self.mean, self.scale, size=x.shape).astype(dt)]


    def infer(self, infos):
        i = infos[0]
        dt = self.dtype or i.dtype
        return [TensorInfo(dt, min(i.level, Level.SHAPED), shape=i.shape, rank_=i.rank_)]


# -- lowerings ----------------------------------------------------------


@lowering("RandomNormalLike")
def random_normal_like(op, inputs, static, device):
    x = inputs[0]
    gen = torch.Generator(device=x.device)
    gen.manual_seed(0 if op.seed is None else int(op.seed))
    out = torch.randn(tuple(x.shape), generator=gen, device=x.device,
                      dtype=torch.float32)
    dt = to_torch(op.dtype or from_torch(x.dtype))
    return [(out * op.scale + op.mean).to(dt)]
