"""int8 weight matmul: the CUDA kernel's wrapper, its launch plan and
its plain version.

Replaces int8_matmul (whisper_tensor_tpu/backends/pallas/quant_matmul.py
:68). The kernel is csrc/int8_matmul.cu; its source note says what
bounds it on the H100 and how its design answers that.

On the device the kernel takes every M, K and N, by one of two paths
(int8_plan below): the CUDA cores at decode M and for f32 x, the tensor
cores at prefill M. The reference's route of more than 512 rows to a
cast and a dense dot (quant_matmul.py:85-89) is a limit of the TPU's
scoped VMEM, which the card does not have, and is not carried over. The
numerics are the reference's: int8 and bf16 values are exact in f32,
the products are summed in f32 (TF32 is off, device.py), the scale is
applied in f32, and the result is rounded to x's type once; the plain
version computes the same in torch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from . import build
from .build import card_sms, check, device_index, library, raw_stream

_DENSE_COLS = 8192      # column chunk of the plain version: bounds the f32 copy


def int8_matmul_plain(x, w_i8, scale) -> torch.Tensor:
    """x (..., K) bf16/f32, w_i8 (K, N) int8, scale (N,) f32 -> (..., N)
    in x's type, computed in f32 and rounded once."""
    K, N = w_i8.shape
    x2 = x.reshape(-1, K).float()
    out = torch.empty((x2.shape[0], N), dtype=x.dtype, device=x.device)
    for n0 in range(0, N, _DENSE_COLS):
        sl = slice(n0, n0 + _DENSE_COLS)
        acc = torch.matmul(x2, w_i8[:, sl].float())
        out[:, sl] = (acc * scale[sl].float()).to(x.dtype)
    return out.reshape(*x.shape[:-1], N)


# -- the launch plan ------------------------------------------------------

# bf16 x with at least this many rows: path (b). chip_smoke.py phase 2
# times both paths at 1 to 16 rows: on an H100 the 16-row tensor tiles
# beat the CUDA cores' 8-row blocks by 2-4% on down and gate/up, and lose
# to their 4-row blocks by 28-35%.
TENSOR_MIN_ROWS = 5
CORE_ROWS = (1, 2, 4, 8)
# The CPU defaults, for the plan's tests, of what wt_int8_limits reads of
# each kernel on the card (Int8Limits): rows of W a stage and columns a
# block by path, blocks a multiprocessor by path, rows of a block and
# x's type, as the H100 gives them.
STAGE_ROWS = {"cores": 128, "tensor": 64}
TILE_COLS = {"cores": 128, "tensor": 128}
BLOCKS_PER_SM = {("cores", 1, True): 3, ("cores", 2, True): 2,
                 ("cores", 4, True): 2, ("cores", 8, True): 1,
                 ("cores", 1, False): 3, ("cores", 2, False): 2,
                 ("cores", 4, False): 2, ("cores", 8, False): 1,
                 ("tensor", 16, True): 4, ("tensor", 64, True): 2,
                 ("tensor", 128, True): 2}
BLOCK_COST = 1 / 128      # a block's fixed cost, in whole-K blocks of work
MAX_SPLITS = 64


@dataclass(frozen=True)
class Int8Limits:
    """What a launch plan sizes its grid by, for one kernel of
    csrc/int8_matmul.cu on one card."""
    stage_rows: int       # rows of W a stage: splits are whole stages
    tile_cols: int        # output columns a block
    blocks_per_sm: int    # blocks a multiprocessor runs at once
    sms: int              # the card's multiprocessors


@functools.lru_cache(maxsize=None)
def kernel_limits(path: str, bm: int, x_bf16: bool,
                  device: Optional[int] = None) -> Int8Limits:
    """The limits of the kernel for `path`, `bm` rows a block and x's
    type: read on CUDA device `device` (wt_int8_limits: the kernel's
    constants and the occupancy calculator), or for None the CPU
    defaults above."""
    if device is None:
        return Int8Limits(STAGE_ROWS[path], TILE_COLS[path],
                          BLOCKS_PER_SM[path, bm, x_bf16], build.card_sms())
    return Int8Limits(*build.kernel_limits(
        "wt_int8_limits", device, int(path == "tensor"), bm, int(x_bf16)),
        card_sms(device))


@dataclass(frozen=True)
class Int8Plan:
    """How one int8_matmul call runs on the card (csrc/int8_matmul.cu):
    `path` "cores" (the decode path, `bm` rows of x a block, 1..8) or
    "tensor" (the prefill path, tiles of `bm` 16, 64 or 128 rows); K
    split into `splits` runs of `kchunk` rows, each a whole number of
    stages."""
    path: str
    bm: int
    splits: int
    kchunk: int


@functools.lru_cache(maxsize=4096)
def int8_plan(M: int, K: int, N: int, x_bf16: bool = True,
              device: Optional[int] = None) -> Int8Plan:
    """The launch plan for x (M, K) @ W (K, N), sized by the kernel's
    limits on CUDA device `device` (kernel_limits; None: the CPU
    defaults).

    bf16 x with at least TENSOR_MIN_ROWS rows takes the tensor cores, any
    other call the CUDA cores (f32 x at every M: the tensor path would
    round x to bf16). There is no row cap."""
    path = "tensor" if x_bf16 and M >= TENSOR_MIN_ROWS else "cores"
    return _path_plan(path, M, K, N, x_bf16, device)


def _path_plan(path: str, M: int, K: int, N: int, x_bf16: bool,
               device: Optional[int]) -> Int8Plan:
    """int8_plan on a given path (chip_smoke.py times both paths at the
    same rows through it): rows a block by M, then K splits of whole
    stages by build.split_units, a wave being blocks_per_sm x sms
    blocks."""
    if path == "tensor":
        bm = 16 if M <= 16 else 64 if M <= 256 else 128
    else:
        bm = next(b for b in CORE_ROWS if b >= min(M, CORE_ROWS[-1]))
    lim = kernel_limits(path, bm, x_bf16, device)
    units = -(-K // lim.stage_rows)
    blocks = -(-M // bm) * -(-N // lim.tile_cols)
    per = build.split_units(units, blocks, lim.blocks_per_sm * lim.sms,
                            BLOCK_COST, MAX_SPLITS)
    return Int8Plan(path, bm, -(-units // per), per * lim.stage_rows)


def int8_matmul(x, w_i8, scale) -> torch.Tensor:
    """W8A16 matmul, x (..., K) bf16/f32/f16 -> (..., N) in x's type.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    at every M, by int8_plan, or raise. A call whose plan splits K runs
    two device kernels (the splits, then their sum); the launch counter
    counts calls, one per call."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_i8, scale)
    if x.dtype == torch.float16:
        # an f16 model: x widened to f32 at the kernel's edge (exact), the
        # f32 result rounded once to f16, as the plain version does
        return int8_matmul(x.float(), w_i8, scale).to(torch.float16)
    K = x.shape[-1]
    M = x.numel() // K if K else 0
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_matmul kernel: x must be bf16, f32 or f16, "
                         f"got {x.dtype}")
    if w_i8.dtype != torch.int8 or w_i8.ndim != 2 or w_i8.shape[0] != K \
            or M == 0:
        raise ValueError(f"int8_matmul kernel: w must be int8 ({K}, N) and "
                         f"x must have rows, got {w_i8.dtype} "
                         f"{tuple(w_i8.shape)}, M={M}")
    N = w_i8.shape[1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (N,):
        raise ValueError(f"int8_matmul kernel: scale must be f32 ({N},), "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    x2 = x.reshape(M, K).contiguous()
    # 16-byte copies of x and W rows start at the tensors' first bytes
    for name, t in (("x", x2), ("w", w_i8), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_matmul kernel: {name} must be a "
                             f"contiguous, 16-byte aligned tensor on "
                             f"{x.device}")
    plan = int8_plan(M, K, N, x.dtype == torch.bfloat16,
                     device_index(x.device))
    return _launch(x2, w_i8, scale, plan).reshape(*x.shape[:-1], N)


def _launch(x2, w_i8, scale, plan: Int8Plan) -> torch.Tensor:
    """Launch the kernel by `plan` (int8_plan's, or another that
    chip_smoke.py times) on checked CUDA inputs, x2 (M, K); (M, N)."""
    (M, K), N = x2.shape, w_i8.shape[1]
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    part = (torch.empty((plan.splits, M, N), dtype=torch.float32,
                        device=x2.device) if plan.splits > 1 else None)
    code = library().wt_int8_matmul(
        x2.data_ptr(), w_i8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), M, K, N,
        int(x2.dtype == torch.bfloat16), int(plan.path == "tensor"), plan.bm,
        plan.splits, plan.kchunk, card_sms(device_index(x2.device)),
        raw_stream(x2.device))
    check(code, "int8_matmul kernel")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
