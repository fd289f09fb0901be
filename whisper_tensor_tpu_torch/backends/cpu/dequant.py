"""Vectorized CPU dequantization for GGUF block formats.

Equivalent of the reference's PackedTensor::dequantize
(src/packed_tensor.rs:96) — numpy-vectorized rather than per-block
loops.

The port's copy of whisper_tensor_tpu/backends/cpu/dequant.py: the 12
block dequantizers, `_unpack_k_scales` and `quantize_blocks` with its
Q4_0/Q8_0/Q5_0/Q4_K/Q6_K writers. The reference's native C++ fast path
(native/wtc) is not ported; in its place a large tensor is dequantized
or quantized in pieces of whole blocks on host threads (`in_pieces`):
every block is computed on its own, so the bytes are the numpy path's.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ...packed_format import QK_K, PackedFormat

PIECE_BLOCKS = 1 << 16        # blocks in one host thread's piece


def in_pieces(fn, n: int, piece: int):
    """[fn(0, n1), fn(n1, n2), ...] over [0, n) cut into pieces of
    `piece`, run on host threads (numpy leaves the GIL in its loops)."""
    bounds = [(i, min(i + piece, n)) for i in range(0, n, piece)] or [(0, 0)]
    if len(bounds) == 1:
        return [fn(*bounds[0])]
    with ThreadPoolExecutor(min(len(bounds), os.cpu_count() or 1)) as ex:
        return list(ex.map(lambda b: fn(*b), bounds))


def dequantize_blocks(data: bytes, fmt: PackedFormat, n_elements: int) -> np.ndarray:
    """Dequantize raw block bytes to float32, flat array of n_elements."""
    fn = _DEQUANT_FNS[fmt]
    nblocks = n_elements // fmt.block_size
    raw = np.frombuffer(data, dtype=np.uint8).reshape(nblocks, fmt.block_bytes)
    return np.concatenate(in_pieces(
        lambda a, b: fn(raw[a:b]).reshape(-1).astype(np.float32),
        nblocks, PIECE_BLOCKS))


def _f16(u8pair: np.ndarray) -> np.ndarray:
    """View pairs of uint8 columns as little-endian float16 scalars."""
    return u8pair.copy().view("<f2").astype(np.float32)


def _deq_q4_0(raw: np.ndarray) -> np.ndarray:
    d = _f16(raw[:, 0:2])  # (nb,1)
    q = raw[:, 2:18]
    lo = (q & 0x0F).astype(np.int8) - 8
    hi = (q >> 4).astype(np.int8) - 8
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return vals * d


def _deq_q4_1(raw: np.ndarray) -> np.ndarray:
    d = _f16(raw[:, 0:2])
    m = _f16(raw[:, 2:4])
    q = raw[:, 4:20]
    lo = (q & 0x0F).astype(np.float32)
    hi = (q >> 4).astype(np.float32)
    vals = np.concatenate([lo, hi], axis=1)
    return vals * d + m


def _deq_q5_0(raw: np.ndarray) -> np.ndarray:
    d = _f16(raw[:, 0:2])
    qh = raw[:, 2:6].copy().view("<u4").astype(np.uint32)  # (nb,1)
    q = raw[:, 6:22]
    lo = (q & 0x0F).astype(np.int32)
    hi = (q >> 4).astype(np.int32)
    idx = np.arange(16, dtype=np.uint32)
    h_lo = ((qh >> idx) & 1).astype(np.int32) << 4          # bits 0..15
    h_hi = ((qh >> (idx + 16)) & 1).astype(np.int32) << 4   # bits 16..31
    vals = np.concatenate([lo | h_lo, hi | h_hi], axis=1).astype(np.float32) - 16.0
    return vals * d


def _deq_q5_1(raw: np.ndarray) -> np.ndarray:
    d = _f16(raw[:, 0:2])
    m = _f16(raw[:, 2:4])
    qh = raw[:, 4:8].copy().view("<u4").astype(np.uint32)
    q = raw[:, 8:24]
    lo = (q & 0x0F).astype(np.int32)
    hi = (q >> 4).astype(np.int32)
    idx = np.arange(16, dtype=np.uint32)
    h_lo = ((qh >> idx) & 1).astype(np.int32) << 4
    h_hi = ((qh >> (idx + 16)) & 1).astype(np.int32) << 4
    vals = np.concatenate([lo | h_lo, hi | h_hi], axis=1).astype(np.float32)
    return vals * d + m


def _deq_q8_0(raw: np.ndarray) -> np.ndarray:
    d = _f16(raw[:, 0:2])
    q = raw[:, 2:34].copy().view(np.int8).astype(np.float32)
    return q * d


def _deq_q8_1(raw: np.ndarray) -> np.ndarray:
    d = _f16(raw[:, 0:2])
    q = raw[:, 4:36].copy().view(np.int8).astype(np.float32)
    return q * d


# -- K-quants (256-element super-blocks) ------------------------------------


def _deq_q2_k(raw: np.ndarray) -> np.ndarray:
    nb = raw.shape[0]
    scales = raw[:, 0:16]                 # 4-bit scale | 4-bit min per 16-el group
    qs = raw[:, 16:80]
    d = _f16(raw[:, 80:82])
    dmin = _f16(raw[:, 82:84])
    sc = (scales & 0x0F).astype(np.float32)      # (nb,16)
    mn = (scales >> 4).astype(np.float32)
    # qs: 64 bytes; element order: for j in 0..3 (chunks of 32 bytes? ggml layout):
    # ggml: for i in 0..2 (128-el halves) ... canonical: q[l] for l in 0..255:
    # value l: byte qs[32*(l//128) + l%32], shift 2*((l%128)//32)
    l = np.arange(256)
    byte_idx = 32 * (l // 128) + (l % 32)
    shift = 2 * ((l % 128) // 32)
    q = ((qs[:, byte_idx] >> shift) & 3).astype(np.float32)  # (nb,256)
    grp = l // 16  # 16-element groups
    return d * sc[:, grp] * q - dmin * mn[:, grp]


def _unpack_k_scales(scales12: np.ndarray) -> tuple:
    """Unpack the 12-byte 6-bit scales/mins used by Q4_K/Q5_K. Returns (sc, m), each (nb, 8)."""
    s = scales12.astype(np.uint8)
    sc = np.empty(s.shape[:1] + (8,), dtype=np.uint8)
    m = np.empty_like(sc)
    for j in range(8):
        if j < 4:
            sc[:, j] = s[:, j] & 63
            m[:, j] = s[:, j + 4] & 63
        else:
            sc[:, j] = (s[:, j + 4] & 0x0F) | ((s[:, j - 4] >> 6) << 4)
            m[:, j] = (s[:, j + 4] >> 4) | ((s[:, j] >> 6) << 4)
    return sc.astype(np.float32), m.astype(np.float32)


def _deq_q4_k(raw: np.ndarray) -> np.ndarray:
    d = _f16(raw[:, 0:2])
    dmin = _f16(raw[:, 2:4])
    sc, mn = _unpack_k_scales(raw[:, 4:16])
    qs = raw[:, 16:144]
    l = np.arange(256)
    byte_idx = 32 * (l // 64) + (l % 32)
    shift = 4 * ((l % 64) // 32)
    q = ((qs[:, byte_idx] >> shift) & 0x0F).astype(np.float32)
    grp = l // 32
    return d * sc[:, grp] * q - dmin * mn[:, grp]


def _deq_q5_k(raw: np.ndarray) -> np.ndarray:
    d = _f16(raw[:, 0:2])
    dmin = _f16(raw[:, 2:4])
    sc, mn = _unpack_k_scales(raw[:, 4:16])
    qh = raw[:, 16:48]
    qs = raw[:, 48:176]
    l = np.arange(256)
    byte_idx = 32 * (l // 64) + (l % 32)
    shift = 4 * ((l % 64) // 32)
    lo = ((qs[:, byte_idx] >> shift) & 0x0F).astype(np.int32)
    hbit = ((qh[:, l % 32] >> (l // 32)) & 1).astype(np.int32) << 4
    q = (lo | hbit).astype(np.float32)
    grp = l // 32
    return d * sc[:, grp] * q - dmin * mn[:, grp]


def _deq_q3_k(raw: np.ndarray) -> np.ndarray:
    hmask = raw[:, 0:32]
    qs = raw[:, 32:96]
    s = raw[:, 96:108].astype(np.uint8)
    d = _f16(raw[:, 108:110])
    # unpack 16 6-bit scales from 12 bytes (ggml K_SCALE layout for q3_k)
    sc = np.empty(raw.shape[:1] + (16,), dtype=np.int8)
    for j in range(16):
        if j < 8:
            low = s[:, j] & 0x0F
        else:
            low = s[:, j - 8] >> 4
        hi = (s[:, 8 + (j % 4)] >> (2 * (j // 4))) & 3
        sc[:, j] = ((low | (hi << 4)).astype(np.int8)) - 32
    l = np.arange(256)
    byte_idx = 32 * (l // 128) + (l % 32)
    shift = 2 * ((l % 128) // 32)
    q = ((qs[:, byte_idx] >> shift) & 3).astype(np.int32)
    hbit = ((hmask[:, l % 32] >> (l // 32)) & 1).astype(np.int32)
    q = q - ((1 - hbit) << 2)  # subtract 4 where high bit NOT set
    grp = l // 16
    return d * sc[:, grp].astype(np.float32) * q.astype(np.float32)


def _deq_q6_k(raw: np.ndarray) -> np.ndarray:
    ql = raw[:, 0:128]
    qh = raw[:, 128:192]
    sc = raw[:, 192:208].copy().view(np.int8).astype(np.float32)  # 16 int8 scales
    d = _f16(raw[:, 208:210])
    l = np.arange(256)
    # ggml q6_k layout: two 128-halves; within each: ql 64 bytes, qh 32 bytes
    half = l // 128
    lh = l % 128
    ql_idx = 64 * half + (lh % 64)
    ql_shift = 4 * (lh // 64)
    qh_idx = 32 * half + (lh % 32)
    qh_shift = 2 * (lh // 32)
    lo = ((ql[:, ql_idx] >> ql_shift) & 0x0F).astype(np.int32)
    hi = ((qh[:, qh_idx] >> qh_shift) & 3).astype(np.int32)
    q = (lo | (hi << 4)) - 32
    grp = l // 16
    return d * sc[:, grp] * q.astype(np.float32)


def _deq_q8_k(raw: np.ndarray) -> np.ndarray:
    d = raw[:, 0:4].copy().view("<f4").astype(np.float32)
    q = raw[:, 4:260].copy().view(np.int8).astype(np.float32)
    return q * d


_DEQUANT_FNS = {
    PackedFormat.Q4_0: _deq_q4_0,
    PackedFormat.Q4_1: _deq_q4_1,
    PackedFormat.Q5_0: _deq_q5_0,
    PackedFormat.Q5_1: _deq_q5_1,
    PackedFormat.Q8_0: _deq_q8_0,
    PackedFormat.Q8_1: _deq_q8_1,
    PackedFormat.Q2_K: _deq_q2_k,
    PackedFormat.Q3_K: _deq_q3_k,
    PackedFormat.Q4_K: _deq_q4_k,
    PackedFormat.Q5_K: _deq_q5_k,
    PackedFormat.Q6_K: _deq_q6_k,
    PackedFormat.Q8_K: _deq_q8_k,
}


# ---------------------------------------------------------------------------
# float32 -> block quantization (the llama.cpp reference rounding), used
# by tests and by benches that build synthetic quantized checkpoints.
# ---------------------------------------------------------------------------

def quantize_blocks(arr: np.ndarray, fmt: PackedFormat) -> bytes:
    """Quantize a flat-able f32 array into raw GGUF block bytes
    (inverse of dequantize_blocks; Q4_0, Q8_0, Q5_0, Q4_K, Q6_K), a
    large array in pieces of whole blocks on host threads."""
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    bs = fmt.block_size
    if flat.size % bs:
        raise ValueError(f"quantize_blocks: {flat.size} values are not whole "
                         f"{fmt.name} blocks of {bs}")
    return b"".join(in_pieces(
        lambda a, b: _quantize_piece(flat[a * bs:b * bs], fmt),
        flat.size // bs, PIECE_BLOCKS))


def _quantize_piece(arr: np.ndarray, fmt: PackedFormat) -> bytes:
    """The reference's quantize_blocks on one piece."""
    x = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1, 32)
    nb = x.shape[0]
    if fmt == PackedFormat.Q8_0:
        amax = np.abs(x).max(axis=1, keepdims=True)
        d = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.round(x / d).clip(-127, 127).astype(np.int8)
        out = np.empty((nb, 34), np.uint8)
        out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 2:34] = q.view(np.uint8)
        return out.tobytes()
    if fmt == PackedFormat.Q4_0:
        # llama.cpp convention: d = signed_max / -8 so the extreme value
        # maps exactly to quant level 0
        imax = np.abs(x).argmax(axis=1)
        vmax = x[np.arange(nb), imax]
        d = np.where(vmax != 0, vmax / -8.0, 1.0).astype(np.float32)
        # f16 storage round-trips BEFORE quantizing so dequant is exact
        d = d.astype(np.float16).astype(np.float32)
        q = np.clip(np.round(x / d[:, None]) + 8, 0, 15).astype(np.uint8)
        out = np.empty((nb, 18), np.uint8)
        out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
        return out.tobytes()
    if fmt == PackedFormat.Q5_0:
        imax = np.abs(x).argmax(axis=1)
        vmax = x[np.arange(nb), imax]
        d = np.where(vmax != 0, vmax / -16.0, 1.0).astype(np.float32)
        d = d.astype(np.float16).astype(np.float32)
        q = np.clip(np.round(x / d[:, None]) + 16, 0, 31).astype(np.uint32)
        out = np.empty((nb, 22), np.uint8)
        out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        hb = (q >> 4) & 1                       # (nb, 32) high bits
        qh = (hb << np.arange(32)).sum(axis=1).astype("<u4")
        out[:, 2:6] = qh.view(np.uint8).reshape(nb, 4)
        lo = (q & 0x0F).astype(np.uint8)
        out[:, 6:22] = lo[:, :16] | (lo[:, 16:] << 4)
        return out.tobytes()
    if fmt == PackedFormat.Q4_K:
        return _quantize_q4_k(arr)
    if fmt == PackedFormat.Q6_K:
        return _quantize_q6_k(arr)
    raise ValueError(f"quantize_blocks: unsupported format {fmt}")


def _pack_k_scales(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_k_scales: (nb, 8) 6-bit ints each -> (nb, 12)
    packed bytes."""
    nb = sc.shape[0]
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    out = np.empty((nb, 12), np.uint8)
    for j in range(4):
        out[:, j] = (sc[:, j] & 63) | (((sc[:, j + 4] >> 4) & 3) << 6)
        out[:, j + 4] = (mn[:, j] & 63) | (((mn[:, j + 4] >> 4) & 3) << 6)
        out[:, j + 8] = (sc[:, j + 4] & 0x0F) | ((mn[:, j + 4] & 0x0F) << 4)
    return out


def _quantize_q4_k(arr: np.ndarray) -> bytes:
    """Simple-search Q4_K writer (per-32-group affine, 6-bit super
    scales): emits VALID blocks — dequantize_blocks is exact on them —
    with near-llama.cpp quality (no iterative refinement)."""
    x = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    g = x.reshape(nb, 8, 32)
    gmin = np.minimum(g.min(axis=2), 0.0)           # mins stored >= 0
    gmax = g.max(axis=2)
    s = np.maximum((gmax - gmin) / 15.0, 0.0)       # per-group scale
    m = -gmin                                       # per-group min
    d = np.maximum(s.max(axis=1, keepdims=True) / 63.0, 1e-12)
    dmin = np.maximum(m.max(axis=1, keepdims=True) / 63.0, 1e-12)
    d16 = d.astype(np.float16).astype(np.float32)
    dmin16 = dmin.astype(np.float16).astype(np.float32)
    sc = np.clip(np.round(s / d16), 0, 63)
    mn = np.clip(np.round(m / dmin16), 0, 63)
    eff_s = np.maximum(d16 * sc, 1e-12)             # (nb, 8)
    eff_m = dmin16 * mn
    q = np.clip(np.round((g + eff_m[:, :, None]) / eff_s[:, :, None]),
                0, 15).astype(np.uint8).reshape(nb, 256)
    out = np.empty((nb, 144), np.uint8)
    out[:, 0:2] = d16.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = dmin16.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 4:16] = _pack_k_scales(sc, mn)
    # qs layout: byte 32c+p packs l = 64c+p (low) and l = 64c+32+p (high)
    b = np.arange(128)
    c, p = b // 32, b % 32
    out[:, 16:144] = (q[:, 64 * c + p]
                      | (q[:, 64 * c + 32 + p] << 4))
    return out.tobytes()


def _quantize_q6_k(arr: np.ndarray) -> bytes:
    """Simple Q6_K writer (per-16-group symmetric, int8 sub-scales)."""
    x = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    g = x.reshape(nb, 16, 16)
    s = np.abs(g).max(axis=2) / 31.0                # per-16 scale
    d = np.maximum(s.max(axis=1, keepdims=True) / 127.0, 1e-12)
    d16 = d.astype(np.float16).astype(np.float32)
    sc = np.clip(np.round(s / d16), 0, 127)
    eff = np.maximum(d16 * sc, 1e-12)
    q = (np.clip(np.round(g / eff[:, :, None]), -32, 31) + 32
         ).astype(np.uint8).reshape(nb, 256)
    out = np.empty((nb, 210), np.uint8)
    # ql byte 64h+p packs l = 128h+p (low nibble) and l = 128h+64+p (hi)
    b = np.arange(64)
    for h in (0, 1):
        out[:, h * 64 + b] = ((q[:, 128 * h + b] & 0x0F)
                              | ((q[:, 128 * h + 64 + b] & 0x0F) << 4))
    # qh byte 32h+p packs bits 4-5 of l = 128h+p+32t at shift 2t
    p = np.arange(32)
    for h in (0, 1):
        acc = np.zeros((nb, 32), np.uint8)
        for t in range(4):
            acc |= ((q[:, 128 * h + 32 * t + p] >> 4) & 3) << (2 * t)
        out[:, 128 + 32 * h + p] = acc
    out[:, 192:208] = sc.astype(np.int8).view(np.uint8)
    out[:, 208:210] = d16.astype(np.float16).view(np.uint8).reshape(nb, 2)
    return out.tobytes()
