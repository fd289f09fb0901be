"""Hand-written CUDA kernels for Hopper (sources in ../../csrc/), each
with a plain PyTorch version beside its wrapper."""

from __future__ import annotations

import torch


def agreement_bound(ref: torch.Tensor, magnitude: torch.Tensor
                    ) -> torch.Tensor:
    """Per-element bound on |kernel - plain| where both compute the same
    sum of terms in f32 and round it once to ref's type.

    `magnitude` is the sum of the terms' absolute values (the plain
    version run on absolute inputs). Two parts:
      * one ulp of ref's type, eps * |ref| (2^-7 for bf16, 2^-23 for
        f32): the two f32 sums may fall on either side of a rounding
        boundary;
      * 2^-16 * magnitude: a sum of n terms in f32 is off the exact sum
        by about sqrt(n) * 2^-24 of the magnitude (rounding errors of
        random sign); for two versions at n <= 2^14 terms that is
        2 * 2^7 * 2^-24.
    Both parts scale with each element, so an error in a few outputs
    (a lost key tile, a wrong weight block) shows against its own size
    and not against the largest output's."""
    eps = torch.finfo(ref.dtype).eps
    return eps * ref.float().abs() + 2.0 ** -16 * magnitude.float().abs()
