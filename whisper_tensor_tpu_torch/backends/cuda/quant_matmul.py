"""int8 weight matmul: the CUDA kernel's wrapper and its plain version.

Replaces int8_matmul (whisper_tensor_tpu/backends/pallas/quant_matmul.py
:68). The kernel is csrc/int8_matmul.cu; its source note says what
bounds it on the H100 and how its design answers that.

As in the reference, the kernel covers M <= 512 rows (decode and
prefill buckets up to 512 tokens). Above that the reference leaves the
product to XLA as a cast plus a dense dot (quant_matmul.py:85-89); the
port does the same with `torch.matmul` on f32 operands. The numerics
stay the reference's: int8 and bf16 values are exact in f32, the
products are summed in f32 (TF32 is off, device.py), the scale is
applied in f32, and the result is rounded to x's type once.
"""

from __future__ import annotations

import torch

from .build import check, library, raw_stream

MAX_KERNEL_ROWS = 512
_DENSE_COLS = 8192      # column chunk of the dense path: bounds the f32 copy


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


def int8_matmul(x, w_i8, scale) -> torch.Tensor:
    """W8A16 matmul, x (..., K) bf16/f32 -> (..., N) in x's type.

    CPU tensors take the plain version. CUDA tensors with at most 512
    rows launch the kernel or raise; more rows take the dense f32 form,
    as the reference does."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_i8, scale)
    K = x.shape[-1]
    M = x.numel() // K if K else 0
    if M > MAX_KERNEL_ROWS:
        return int8_matmul_plain(x, w_i8, scale)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_matmul kernel: x must be bf16 or f32, "
                         f"got {x.dtype}")
    if w_i8.dtype != torch.int8 or w_i8.ndim != 2 or w_i8.shape[0] != K:
        raise ValueError(f"int8_matmul kernel: w must be int8 ({K}, N), "
                         f"got {w_i8.dtype} {tuple(w_i8.shape)}")
    N = w_i8.shape[1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (N,):
        raise ValueError(f"int8_matmul kernel: scale must be f32 ({N},), "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if K % 8 or N % 16 or M == 0:
        # the kernel copies x and weight rows in whole 16-byte pieces
        raise ValueError(f"int8_matmul kernel: needs K % 8 == 0, N % 16 == 0 "
                         f"and M > 0, got M={M} K={K} N={N}")
    x2 = x.reshape(M, K).contiguous()
    for name, t in (("x", x2), ("w", w_i8), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_matmul kernel: {name} must be a "
                             f"contiguous, 16-byte aligned tensor on "
                             f"{x.device}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    code = library().wt_int8_matmul(
        x2.data_ptr(), w_i8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, K, N, int(x.dtype == torch.bfloat16),
        raw_stream(x.device))
    check(code, "int8_matmul kernel")
    int8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


int8_matmul.launches = 0
