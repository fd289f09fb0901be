"""Packed-weight (GGUF / host-quantized) matmul: the numpy repack, the
CUDA kernel's wrapper and its plain version.

Replaces packed_matmul (whisper_tensor_tpu/backends/pallas/
packed_matmul.py:278). The kernel is csrc/packed_matmul.cu; its source
note says what bounds it on the H100 and how its design answers that.

The host half is the port's copy of that module's numpy code (:54-262):
`_q4_block_values`, `_q5_bits`, `_block_affine`, `SUPPORTED`,
`repack_packed_tensor` and `dequant_repacked`. They turn any of the 12
GGUF block formats into one device layout,
    W[k, n] = q[k, n] * scales[k // G, n] - offsets[k // G, n],
bits 4: q (K/2, N) uint8, the low nibble of byte (r, n) is row r and
the high nibble row r + K/2; bits 8: q (K, N) int8; scales and offsets
(K/G, N) float32, G = K / scales.shape[0] (32 for the classic blocks,
16 for the Q2_K/Q3_K/Q6_K sub-scales, 256 for Q8_K, 64/128 for GPTQ/
AWQ groups). The repack is exact: dequant_repacked equals
backends/cpu/dequant.py's dequantize_blocks(...).T bit for bit.

On the device the kernel takes every M at any N and any G dividing K,
by one of two paths (packed_plan below, and the source note): the CUDA
cores at decode M and for f32 x, the tensor cores at prefill M. The
reference's route of more than 512 rows to a dequantize-and-dot form
(:294-302) is a limit of the TPU's scoped VMEM, which the card does not
have, and is not carried over. The plain version dequantizes as
dequant_repacked does (q * s, then - o, each rounded in f32), multiplies
in f32 (TF32 is off, device.py) and rounds the result to x's type once.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ...packed_format import PackedFormat
from ..cpu.dequant import PIECE_BLOCKS, in_pieces
from . import build, refuse_grad
from .build import card_sms, check, device_index, library, raw_stream

_DENSE_COLS = 8192      # column chunk of the plain version: bounds the f32 copy


# -- the host repack (numpy), the reference's :54-262 ----------------------

def _f16_to_f32(u8pair: np.ndarray) -> np.ndarray:
    return u8pair.copy().view(np.float16).astype(np.float32)


def _q4_block_values(raw: np.ndarray, fmt: PackedFormat):
    """raw (nb, block_bytes) -> (nibbles (nb, bs) uint8 in 0..15,
    scales (nb, bs//32) f32, offsets (nb, bs//32) f32)."""
    if fmt == PackedFormat.Q4_0:
        d = _f16_to_f32(raw[:, 0:2])                      # (nb, 1)
        q = raw[:, 2:18]
        nib = np.concatenate([q & 0x0F, q >> 4], axis=1)  # (nb, 32)
        return nib, d, 8.0 * d
    if fmt == PackedFormat.Q4_1:
        d = _f16_to_f32(raw[:, 0:2])
        m = _f16_to_f32(raw[:, 2:4])
        q = raw[:, 4:20]
        nib = np.concatenate([q & 0x0F, q >> 4], axis=1)
        return nib, d, -m
    if fmt == PackedFormat.Q4_K:
        from ..cpu.dequant import _unpack_k_scales

        d = _f16_to_f32(raw[:, 0:2])
        dmin = _f16_to_f32(raw[:, 2:4])
        sc, mn = _unpack_k_scales(raw[:, 4:16])           # (nb, 8)
        qs = raw[:, 16:144]
        l = np.arange(256)
        byte_idx = 32 * (l // 64) + (l % 32)
        shift = 4 * ((l % 64) // 32)
        nib = ((qs[:, byte_idx] >> shift) & 0x0F)         # (nb, 256)
        return nib, d * sc, dmin * mn
    raise ValueError(f"unsupported 4-bit format {fmt}")


def _q5_bits(raw: np.ndarray, qh_off: int, qs_off: int):
    """Shared Q5_0/Q5_1 5-bit reconstruction -> (nb, 32) ints 0..31."""
    qh = raw[:, qh_off:qh_off + 4].copy().view("<u4").astype(np.uint32)
    q = raw[:, qs_off:qs_off + 16]
    lo = (q & 0x0F).astype(np.int32)
    hi = (q >> 4).astype(np.int32)
    idx = np.arange(16, dtype=np.uint32)
    h_lo = ((qh >> idx) & 1).astype(np.int32) << 4
    h_hi = ((qh >> (idx + 16)) & 1).astype(np.int32) << 4
    return np.concatenate([lo | h_lo, hi | h_hi], axis=1)


def _block_affine(raw: np.ndarray, fmt: PackedFormat):
    """Any GGUF block format -> the kernel's uniform affine form:
    (vals (nb, bs) ints >= 0, scales (nb, n_groups) f32, offsets
    (nb, n_groups) f32, bits) with W = vals * scale - offset per
    (bs // n_groups)-element group. 4-bit-storable formats (vals
    0..15) return bits=4 (nibble-packed on the device); wider vals
    return bits=8 (int8 on the device: Q5/Q6 spend 1 B/weight, in
    exchange for no per-element bit surgery in the kernel)."""
    from ..cpu.dequant import _unpack_k_scales

    if fmt in (PackedFormat.Q4_0, PackedFormat.Q4_1, PackedFormat.Q4_K):
        nib, sc, off = _q4_block_values(raw, fmt)
        return nib, sc, off, 4
    if fmt == PackedFormat.Q5_0:
        d = _f16_to_f32(raw[:, 0:2])
        return _q5_bits(raw, 2, 6), d, 16.0 * d, 8
    if fmt == PackedFormat.Q5_1:
        d = _f16_to_f32(raw[:, 0:2])
        m = _f16_to_f32(raw[:, 2:4])
        return _q5_bits(raw, 4, 8), d, -m, 8
    if fmt == PackedFormat.Q8_1:
        d = _f16_to_f32(raw[:, 0:2])
        q = raw[:, 4:36].copy().view(np.int8).astype(np.int32)
        return q, d, np.zeros_like(d), 8
    if fmt == PackedFormat.Q2_K:
        sc_raw = raw[:, 0:16]
        qs = raw[:, 16:80]
        d = _f16_to_f32(raw[:, 80:82])
        dmin = _f16_to_f32(raw[:, 82:84])
        l = np.arange(256)
        q = ((qs[:, 32 * (l // 128) + (l % 32)]
              >> (2 * ((l % 128) // 32))) & 3).astype(np.int32)
        sc = (sc_raw & 0x0F).astype(np.float32)         # (nb, 16)
        mn = (sc_raw >> 4).astype(np.float32)
        return q, d * sc, dmin * mn, 4
    if fmt == PackedFormat.Q3_K:
        hmask = raw[:, 0:32]
        qs = raw[:, 32:96]
        s = raw[:, 96:108].astype(np.uint8)
        d = _f16_to_f32(raw[:, 108:110])
        sc = np.empty(raw.shape[:1] + (16,), dtype=np.int8)
        for j in range(16):
            low = (s[:, j] & 0x0F) if j < 8 else (s[:, j - 8] >> 4)
            hi = (s[:, 8 + (j % 4)] >> (2 * (j // 4))) & 3
            sc[:, j] = ((low | (hi << 4)).astype(np.int8)) - 32
        l = np.arange(256)
        q2 = ((qs[:, 32 * (l // 128) + (l % 32)]
               >> (2 * ((l % 128) // 32))) & 3).astype(np.int32)
        hbit = ((hmask[:, l % 32] >> (l // 32)) & 1).astype(np.int32)
        # value = d*sc*(q2 + 4*hbit - 4): store u = q2|(hbit<<2) in
        # 0..7 (nibble) with offset 4*d*sc
        u = q2 | (hbit << 2)
        ds = d * sc.astype(np.float32)
        return u, ds, 4.0 * ds, 4
    if fmt == PackedFormat.Q5_K:
        d = _f16_to_f32(raw[:, 0:2])
        dmin = _f16_to_f32(raw[:, 2:4])
        sc, mn = _unpack_k_scales(raw[:, 4:16])
        qh = raw[:, 16:48]
        qs = raw[:, 48:176]
        l = np.arange(256)
        lo = ((qs[:, 32 * (l // 64) + (l % 32)]
               >> (4 * ((l % 64) // 32))) & 0x0F).astype(np.int32)
        hbit = ((qh[:, l % 32] >> (l // 32)) & 1).astype(np.int32) << 4
        return lo | hbit, d * sc, dmin * mn, 8
    if fmt == PackedFormat.Q6_K:
        ql = raw[:, 0:128]
        qh = raw[:, 128:192]
        sc = raw[:, 192:208].copy().view(np.int8).astype(np.float32)
        d = _f16_to_f32(raw[:, 208:210])
        l = np.arange(256)
        half, lh = l // 128, l % 128
        lo = ((ql[:, 64 * half + (lh % 64)]
               >> (4 * (lh // 64))) & 0x0F).astype(np.int32)
        hi = ((qh[:, 32 * half + (lh % 32)]
               >> (2 * (lh // 32))) & 3).astype(np.int32)
        # value = d*sc*((lo|hi<<4) - 32)
        ds = d * sc
        return lo | (hi << 4), ds, 32.0 * ds, 8
    if fmt == PackedFormat.Q8_K:
        d = raw[:, 0:4].copy().view("<f4").astype(np.float32)
        q = raw[:, 4:260].copy().view(np.int8).astype(np.int32)
        return q, d, np.zeros_like(d), 8
    raise ValueError(f"unsupported format {fmt}")


SUPPORTED_4BIT = (PackedFormat.Q4_0, PackedFormat.Q4_1, PackedFormat.Q4_K,
                  PackedFormat.Q2_K, PackedFormat.Q3_K)
SUPPORTED = SUPPORTED_4BIT + (
    PackedFormat.Q8_0, PackedFormat.Q5_0, PackedFormat.Q5_1,
    PackedFormat.Q8_1, PackedFormat.Q5_K, PackedFormat.Q6_K,
    PackedFormat.Q8_K)


def repack_packed_tensor(pt) -> Optional[Dict[str, np.ndarray]]:
    """PackedTensor in GGUF orientation (N, K), blocks along K, used as
    a matmul RHS after transpose -> the device layout of the kernel
    operating on W = dequant(pt).T of shape (K, N).

    Returns None when the format/shape isn't kernel-eligible (caller
    falls back to host dequantization)."""
    if len(pt.shape) != 2:
        return None
    fmt = pt.fmt
    if fmt not in SUPPORTED:
        return None
    N, K = pt.shape                    # GGUF orientation
    bs = fmt.block_size
    if K % max(bs, 64) or K % 64:
        return None
    # rows of a large tensor repack in pieces on host threads; each
    # output column is one row's, so the pieces join column-wise
    raw = np.frombuffer(pt.data, dtype=np.uint8).reshape(N, -1)
    parts = in_pieces(lambda a, b: _repack_rows(raw[a:b], fmt, b - a, K), N,
                      max(1, PIECE_BLOCKS // (K // bs)))
    if len(parts) == 1:
        return parts[0]
    out = {k: np.concatenate([p[k] for p in parts], axis=1)
           for k in ("q", "scales", "offsets")}
    out["bits"] = parts[0]["bits"]
    out["has_off"] = np.bool_(any(bool(p["has_off"]) for p in parts))
    return out


def _repack_rows(rows: np.ndarray, fmt: PackedFormat, N: int, K: int):
    """The reference's repack (:206-243) of N rows of blocks."""
    bs = fmt.block_size
    raw = rows.reshape(-1, fmt.block_bytes)

    if fmt == PackedFormat.Q8_0:
        d = _f16_to_f32(raw[:, 0:2])                       # (nb, 1)
        q = raw[:, 2:34].copy().view(np.int8)              # (nb, 32)
        q_kn = q.reshape(N, K).T.copy()                    # (K, N) int8
        s_kn = d.reshape(N, K // 32).T.copy()              # (K//32, N)
        return {"q": q_kn, "scales": s_kn,
                "offsets": np.zeros_like(s_kn), "bits": np.int8(8),
                "has_off": np.bool_(False)}

    vals, sc, off, bits = _block_affine(raw, fmt)
    n_groups = max(sc.shape[1], off.shape[1])
    gw = bs // n_groups                # K-group width (32, or 16 K-quant)
    vals_kn = vals.reshape(N, K).T                         # (K, N) ints

    # sc/off are (nb, 1) or (nb, n_groups): expand to one value per
    # gw-element K-group, then lay out (K//gw, N)
    def expand(a):
        a = np.broadcast_to(a, (a.shape[0], n_groups))
        return np.ascontiguousarray(
            a.reshape(N, K // gw).T.astype(np.float32))    # (K//gw, N)

    s_kn = expand(sc)
    o_kn = expand(off)
    has_off = bool(np.any(o_kn))
    if bits == 8:
        return {"q": vals_kn.astype(np.int8).copy(), "scales": s_kn,
                "offsets": o_kn, "bits": np.int8(8),
                "has_off": np.bool_(has_off)}
    half = K // 2
    q_u8 = (vals_kn[:half] | (vals_kn[half:] << 4)).astype(np.uint8).copy()
    return {"q": q_u8, "scales": s_kn, "offsets": o_kn, "bits": np.int8(4),
            "has_off": np.bool_(has_off)}


def dequant_repacked(rp: Dict[str, np.ndarray]) -> np.ndarray:
    """Reference dequantization of the REPACKED layout (numpy, f32) —
    the oracle the kernel and its plain version are checked against.
    Must equal backends.cpu.dequant.dequantize_blocks(...).T exactly.

    The K-group size is carried by the shapes: g = K / scales.shape[0]
    (32 for GGUF blocks; 64/128 for GPTQ/AWQ groups)."""
    bits = int(rp["bits"])
    K = rp["q"].shape[0] * (2 if bits == 4 else 1)
    g = K // rp["scales"].shape[0]
    s = np.repeat(rp["scales"], g, axis=0)
    o = np.repeat(rp["offsets"], g, axis=0)
    if bits == 8:
        return rp["q"].astype(np.float32) * s - o
    q = rp["q"]
    nib = np.concatenate([q & 0x0F, q >> 4], axis=0).astype(np.float32)
    return nib * s - o


# -- the device half -------------------------------------------------------

def dequantize_packed(q, scales, offsets, bits: int, has_off: bool = True,
                      cols: slice = slice(None)) -> torch.Tensor:
    """W[:, cols] (K, n) f32 from the packed layout, on q's device: q *
    s rounded, then - o rounded, as dequant_repacked (bits 8 without
    offsets skips the subtraction, as the reference's _dequant_jnp)."""
    q, s, o = q[:, cols], scales[:, cols], offsets[:, cols]
    if bits == 4:
        q = torch.cat([q & 0x0F, q >> 4], dim=0)
    g = q.shape[0] // s.shape[0]
    w = q.float() * s.repeat_interleave(g, dim=0)
    if bits == 4 or has_off:
        w = w - o.repeat_interleave(g, dim=0)
    return w


def packed_matmul_plain(x, q, scales, offsets, bits: int,
                        has_off: bool = True) -> torch.Tensor:
    """x (..., K) bf16/f32 @ W (K, N) -> (..., N) in x's type: W
    dequantized in f32 by column chunks, products summed in f32, the
    result rounded once (reference _dequant_jnp + f32 dot, :298-302,
    :439-449)."""
    N = q.shape[1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K).float()
    out = torch.empty((x2.shape[0], N), dtype=x.dtype, device=x.device)
    for n0 in range(0, N, _DENSE_COLS):
        sl = slice(n0, n0 + _DENSE_COLS)
        w = dequantize_packed(q, scales, offsets, bits, has_off, sl)
        out[:, sl] = torch.matmul(x2, w).to(x.dtype)
    return out.reshape(*x.shape[:-1], N)


# -- the launch plan ------------------------------------------------------

TENSOR_MIN_ROWS = 9       # bf16 x with at least this many rows: path (b)
CORE_ROWS = (1, 2, 4, 8, 16)
# The CPU defaults, for the plan's tests, of what wt_packed_limits reads
# of each kernel on the card (KernelLimits): rows of q a stage by path
# and bits, columns a block by path, and blocks a multiprocessor by path
# and rows of a block, as the H100 gives them at bits 4, G 32 and bf16 x
# (other layouts change a block's shared memory and registers).
STAGE_Q_ROWS = {("cores", 4): 64, ("cores", 8): 128,
                ("tensor", 4): 32, ("tensor", 8): 64}
TILE_COLS = {"cores": 128, "tensor": 128}
BLOCKS_PER_SM = {("cores", 1): 3, ("cores", 2): 2, ("cores", 4): 2,
                 ("cores", 8): 2, ("cores", 16): 1, ("tensor", 16): 2,
                 ("tensor", 64): 2}
BLOCK_COST = 1 / 128      # a block's fixed cost, in whole-K blocks of work
MAX_SPLITS = 64


@dataclass(frozen=True)
class KernelLimits:
    """What a launch plan sizes its grid by, for one kernel of
    csrc/packed_matmul.cu on one card."""
    stage_q_rows: int     # rows of q a stage: splits are whole stages
    tile_cols: int        # output columns a block
    blocks_per_sm: int    # blocks a multiprocessor runs at once
    sms: int              # the card's multiprocessors


@functools.lru_cache(maxsize=None)
def kernel_limits(path: str, bm: int, bits: int, x_bf16: bool, G: int,
                  device: Optional[int] = None) -> KernelLimits:
    """The limits of the kernel for `path`, `bm` rows a block, `bits`,
    x's type and groups of G rows: read on CUDA device `device`
    (wt_packed_limits: the kernel's constants and the occupancy
    calculator), or for None the CPU defaults above."""
    if device is None:
        return KernelLimits(STAGE_Q_ROWS[path, bits], TILE_COLS[path],
                            BLOCKS_PER_SM[path, bm], card_sms())
    return KernelLimits(*build.kernel_limits(
        "wt_packed_limits", device, int(path == "tensor"), bm, bits,
        int(x_bf16), G), card_sms(device))


@dataclass(frozen=True)
class PackedPlan:
    """How one packed_matmul call runs on the card (csrc/packed_matmul.cu):
    `path` "cores" (the decode path, `bm` rows of x per block, BM 1..16)
    or "tensor" (the prefill path, tiles of `bm` 16 or 64 rows); K split into `splits`
    runs of `kchunk` rows of q, each a whole number of stages and of
    groups where the shapes allow (bits 4: a q row holds W rows r and
    r + K/2, so both nibbles stay in one split)."""
    path: str
    bm: int
    splits: int
    kchunk: int


@functools.lru_cache(maxsize=4096)
def packed_plan(M: int, K: int, N: int, G: int, bits: int,
                x_bf16: bool = True,
                device: Optional[int] = None) -> PackedPlan:
    """The launch plan for x (M, K) @ W (K, N) in groups of G rows, sized
    by the kernel's limits on CUDA device `device` (kernel_limits; None:
    the CPU defaults).

    bf16 x with at least TENSOR_MIN_ROWS rows takes the tensor cores, any
    other call the CUDA cores (f32 x at every M: the tensor path rounds x
    to bf16). There is no row cap."""
    path = "tensor" if x_bf16 and M >= TENSOR_MIN_ROWS else "cores"
    return _path_plan(path, M, K, N, G, bits, x_bf16, device)


def _path_plan(path: str, M: int, K: int, N: int, G: int, bits: int,
               x_bf16: bool, device: Optional[int]) -> PackedPlan:
    """packed_plan on a given path (chip_smoke.py times both paths at the
    same rows through it). K splits of whole stages and groups, chosen by
    build.split_units, a wave being blocks_per_sm x sms blocks."""
    if path == "tensor":
        bm = 16 if M <= 16 else 64
    else:
        bm = next(b for b in CORE_ROWS if b >= min(M, 16))
    lim = kernel_limits(path, bm, bits, x_bf16, G, device)
    kq = K // 2 if bits == 4 else K
    unit = math.lcm(lim.stage_q_rows, G)            # stages and groups
    units = -(-kq // unit)
    blocks = -(-M // bm) * -(-N // lim.tile_cols)
    per = build.split_units(units, blocks, lim.blocks_per_sm * lim.sms,
                            BLOCK_COST, MAX_SPLITS)
    return PackedPlan(path, bm, -(-units // per), per * unit)


def packed_matmul(x, q, scales, offsets, bits: int,
                  has_off: bool = True) -> torch.Tensor:
    """x (..., K) bf16/f32/f16 @ dequant(q, scales, offsets) (K, N) -> (...,
    N) in x's type.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    at every M, by packed_plan, or raise. A call whose plan splits K
    runs two device kernels (the splits, then their sum); the launch
    counter counts calls, one per call."""
    refuse_grad("packed_matmul", x, scales, offsets)
    if x.device.type == "cpu":
        return packed_matmul_plain(x, q, scales, offsets, bits, has_off)
    if x.dtype == torch.float16:
        # an f16 model: x widened to f32 at the kernel's edge (exact), the
        # f32 result rounded once to f16, as the plain version does
        return packed_matmul(x.float(), q, scales, offsets, bits,
                             has_off).to(torch.float16)
    K = x.shape[-1]
    M = x.numel() // K if K else 0
    bits = int(bits)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"packed_matmul kernel: x must be bf16, f32 or f16, "
                         f"got {x.dtype}")
    want = {4: (torch.uint8, K // 2), 8: (torch.int8, K)}.get(bits)
    if want is None or q.ndim != 2 or (q.dtype, q.shape[0]) != want \
            or K % 16 or M == 0:
        raise ValueError(
            f"packed_matmul kernel: needs bits 4 (q uint8 (K/2, N)) or 8 "
            f"(q int8 (K, N)), K % 16 == 0 and M > 0; got bits={bits}, q "
            f"{q.dtype} {tuple(q.shape)}, M={M} K={K}")
    N = q.shape[1]
    Kg = scales.shape[0] if scales.ndim == 2 else 0
    for name, t in (("scales", scales), ("offsets", offsets)):
        if t.dtype != torch.float32 or t.ndim != 2 or tuple(t.shape) != (
                Kg, N) or Kg == 0 or K % Kg:
            raise ValueError(
                f"packed_matmul kernel: {name} must be f32 (K/G, N) with G "
                f"dividing K={K}, got {t.dtype} {tuple(t.shape)}")
    x2 = x.reshape(M, K).contiguous()
    # 16-byte copies of x; of q rows and of scales and offsets only when
    # N % 16 == 0 (the kernel copies bytes and floats otherwise)
    align = 16 if N % 16 == 0 else 4
    for name, t, a in (("x", x2, 16), ("q", q, align),
                       ("scales", scales, align), ("offsets", offsets, align)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % a:
            raise ValueError(f"packed_matmul kernel: {name} must be a "
                             f"contiguous, {a}-byte aligned tensor on "
                             f"{x.device}")
    plan = packed_plan(M, K, N, K // Kg, bits, x.dtype == torch.bfloat16,
                       device_index(x.device))
    return _launch(x2, q, scales, offsets, bits, has_off, plan).reshape(
        *x.shape[:-1], N)


def _launch(x2, q, scales, offsets, bits: int, has_off: bool,
            plan: PackedPlan) -> torch.Tensor:
    """Launch the kernel by `plan` (packed_plan's, or another that
    chip_smoke.py times) on checked CUDA inputs, x2 (M, K); (M, N)."""
    (M, K), N = x2.shape, q.shape[1]
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    part = (torch.empty((plan.splits, M, N), dtype=torch.float32,
                        device=x2.device) if plan.splits > 1 else None)
    code = library().wt_packed_matmul(
        x2.data_ptr(), q.data_ptr(), scales.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), M, K, N,
        K // scales.shape[0], bits, int(bool(has_off)),
        int(x2.dtype == torch.bfloat16), int(plan.path == "tensor"), plan.bm,
        plan.splits, plan.kchunk, card_sms(device_index(x2.device)),
        raw_stream(x2.device))
    check(code, "packed_matmul kernel")
    packed_matmul.launches += 1
    return out


packed_matmul.launches = 0
