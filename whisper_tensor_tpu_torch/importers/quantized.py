"""GPTQ / AWQ quantized-checkpoint support.

The port's copy of whisper_tensor_tpu/importers/quantized.py (numpy
only). Transformers checkpoints whose config.json carries a
`quantization_config` with quant_method "gptq" or "awq" load directly.
Each quantized Linear (qweight/qzeros/scales[/g_idx]) is exposed two
ways:

  * dense: `QuantizedStore.load("...weight")` dequantizes on the host
    into the standard HF Linear (out, in) layout, so every recipe works
    unchanged (the dense copy stays in host RAM only);
  * packed: `QuantizedStore.packed_source(hf_name)` returns the device
    layout of the packed_matmul kernel (backends/cuda/packed_matmul.py)
    -- q (K//2, N) nibble-packed uint8 + per-group scales/offsets -- so
    4-bit weights stream from device memory at 4 bits a weight.
    GPTQ/AWQ group scales are affine per K-group, exactly the kernel's
    W = q * scale - offset form (group size carried by the array
    shapes: g = K // scales.shape[0]).

Which weights pack (repack_for_kernel): the kernel's own rule, K a
multiple of 16 and the group size dividing K, at any N. The reference
also requires N % 128 == 0, the TPU's lane width; the card has no such
lane rule and the kernel takes any N, so the port drops it (a GPTQ k/v
projection of 64 or 1,024 columns packs too). desc_act=True (a
non-trivial g_idx) stays on the dense path, as in the reference: a
per-row group indirection is not a contiguous-group layout.

Packing conventions implemented (and round-trip tested against our own
packers, since no GPTQ/AWQ library is a dependency):

  GPTQ int4: qweight int32 (K/8, N), 8 nibbles per word along K in
    natural order; qzeros int32 (K/g, N/8), 8 nibbles per word along N
    in natural order, stored MINUS 1 in the classic "gptq" checkpoint
    format (the +1 is re-added on load; checkpoint_format/meta "gptq_v2"
    stores the true zero); scales (K/g, N). W = (q - zero) * scale.

  AWQ int4: qweight int32 (K, N/8), 8 nibbles per word along N in the
    interleaved order [0, 2, 4, 6, 1, 3, 5, 7] (unpack with the inverse
    [0, 4, 1, 5, 2, 6, 3, 7]); qzeros int32 (K/g, N/8) same order, true
    zeros; scales (K/g, N). W = (q - zero) * scale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

# AWQ packs logical nibble j of a group of 8 into physical slot
# AWQ_PACK_ORDER.index(j); unpacking applies AWQ_UNPACK_ORDER.
AWQ_PACK_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]
AWQ_UNPACK_ORDER = [0, 4, 1, 5, 2, 6, 3, 7]


@dataclass
class QuantSpec:
    method: str          # "gptq" | "awq"
    bits: int
    group_size: int
    desc_act: bool = False
    v2: bool = False     # gptq_v2: zeros stored without the -1 bias


def parse_quantization_config(hf_cfg: dict) -> Optional[QuantSpec]:
    qc = hf_cfg.get("quantization_config")
    if not qc:
        return None
    method = str(qc.get("quant_method", "")).lower()
    if method not in ("gptq", "awq"):
        return None
    bits = int(qc.get("bits", qc.get("w_bit", 4)))
    group = int(qc.get("group_size", qc.get("q_group_size", 128)))
    v2 = str(qc.get("checkpoint_format", "")).lower() == "gptq_v2" or \
        str((qc.get("meta") or {}).get("checkpoint_format", "")).lower() \
        == "gptq_v2"
    return QuantSpec(method=method, bits=bits, group_size=group,
                     desc_act=bool(qc.get("desc_act", False)), v2=v2)


# ---------------------------------------------------------------------------
# int32 nibble (un)packing
# ---------------------------------------------------------------------------

def _unpack_int32_nibbles(words: np.ndarray, axis: int) -> np.ndarray:
    """int32 (…) -> uint8 nibbles expanded 8x along `axis`, natural
    order (nibble j = bits [4j, 4j+4))."""
    w = words.astype(np.uint32)
    if axis < 0:
        axis += w.ndim
    parts = [((w >> (4 * j)) & 0xF).astype(np.uint8) for j in range(8)]
    st = np.stack(parts, axis=axis + 1)
    shape = list(w.shape)
    shape[axis] *= 8
    return st.reshape(shape)


def _pack_int32_nibbles(nib: np.ndarray, axis: int) -> np.ndarray:
    """uint8 nibbles -> int32 words packed 8x along `axis`."""
    if axis == 0:
        n = nib.reshape(nib.shape[0] // 8, 8, *nib.shape[1:])
        out = np.zeros((n.shape[0], *nib.shape[1:]), np.uint32)
        for j in range(8):
            out |= (n[:, j].astype(np.uint32) & 0xF) << (4 * j)
    else:  # last axis
        n = nib.reshape(*nib.shape[:-1], nib.shape[-1] // 8, 8)
        out = np.zeros(n.shape[:-1], np.uint32)
        for j in range(8):
            out |= (n[..., j].astype(np.uint32) & 0xF) << (4 * j)
    return out.view(np.int32)


# ---------------------------------------------------------------------------
# GPTQ
# ---------------------------------------------------------------------------

def unpack_gptq(qweight: np.ndarray, qzeros: np.ndarray,
                scales: np.ndarray, spec: QuantSpec):
    """-> (q (K, N) uint8 0..15, zeros (K/g, N) f32, scales (K/g, N) f32)."""
    if spec.bits != 4:
        raise ValueError(f"only 4-bit GPTQ supported (got {spec.bits})")
    q = _unpack_int32_nibbles(qweight, axis=0)            # (K, N)
    z = _unpack_int32_nibbles(qzeros, axis=-1)            # (K/g, N)
    z = z.astype(np.float32)
    if not spec.v2:
        z = z + 1.0                                        # classic bias
    return q, z, scales.astype(np.float32)


def pack_gptq(q: np.ndarray, zeros: np.ndarray, scales: np.ndarray,
              spec: QuantSpec):
    """Inverse of unpack_gptq — produces checkpoint-format arrays."""
    qweight = _pack_int32_nibbles(q.astype(np.uint8), axis=0)
    z = zeros.astype(np.int64)
    if not spec.v2:
        z = z - 1
    qzeros = _pack_int32_nibbles((z & 0xF).astype(np.uint8), axis=-1)
    return qweight, qzeros, scales.astype(np.float16)


# ---------------------------------------------------------------------------
# AWQ
# ---------------------------------------------------------------------------

def _awq_reorder(nib: np.ndarray, order) -> np.ndarray:
    n = nib.reshape(*nib.shape[:-1], nib.shape[-1] // 8, 8)
    return n[..., order].reshape(nib.shape)


def unpack_awq(qweight: np.ndarray, qzeros: np.ndarray,
               scales: np.ndarray, spec: QuantSpec):
    """-> (q (K, N) uint8, zeros (K/g, N) f32, scales (K/g, N) f32)."""
    if spec.bits != 4:
        raise ValueError(f"only 4-bit AWQ supported (got {spec.bits})")
    q = _unpack_int32_nibbles(qweight, axis=-1)           # (K, N) interleaved
    q = _awq_reorder(q, AWQ_UNPACK_ORDER)
    z = _unpack_int32_nibbles(qzeros, axis=-1)
    z = _awq_reorder(z, AWQ_UNPACK_ORDER).astype(np.float32)
    return q, z, scales.astype(np.float32)


def pack_awq(q: np.ndarray, zeros: np.ndarray, scales: np.ndarray,
             spec: QuantSpec):
    qw = _awq_reorder(q.astype(np.uint8), AWQ_PACK_ORDER)
    qweight = _pack_int32_nibbles(qw, axis=-1)
    qz = _awq_reorder((zeros.astype(np.int64) & 0xF).astype(np.uint8),
                      AWQ_PACK_ORDER)
    qzeros = _pack_int32_nibbles(qz, axis=-1)
    return qweight, qzeros, scales.astype(np.float16)


# ---------------------------------------------------------------------------
# dequantization / device repack
# ---------------------------------------------------------------------------

def _expand_groups(a: np.ndarray, K: int, g_idx: Optional[np.ndarray],
                   g: int) -> np.ndarray:
    if g_idx is not None:
        return a[np.asarray(g_idx, np.int64)]
    return np.repeat(a, g, axis=0)[:K]


def dequant_dense(q: np.ndarray, zeros: np.ndarray, scales: np.ndarray,
                  g_idx: Optional[np.ndarray] = None) -> np.ndarray:
    """(K, N) f32 matmul-RHS orientation; transpose for HF Linear."""
    K = q.shape[0]
    g = -(-K // zeros.shape[0])
    z = _expand_groups(zeros, K, g_idx, g)
    s = _expand_groups(scales, K, g_idx, g)
    return (q.astype(np.float32) - z) * s


def repack_for_kernel(q: np.ndarray, zeros: np.ndarray,
                      scales: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
    """-> the packed_matmul kernel's device layout: W = q*s - off with
    q (K//2, N) nibble-packed (row k low, row k+K//2 high),
    scales/offsets (K/g, N) f32, `has_off` (the port's PackedMatMul
    reads it; zero points make offsets). None when the kernel cannot
    take the shape: K not a multiple of 16, or g not dividing K."""
    K, N = q.shape
    if K % 16:
        return None
    g = K // zeros.shape[0]
    if zeros.shape[0] * g != K:
        return None
    half = K // 2
    q_u8 = (q[:half] | (q[half:] << 4)).astype(np.uint8)
    s = scales.astype(np.float32)
    off = (zeros * scales).astype(np.float32)
    return {"q": np.ascontiguousarray(q_u8),
            "scales": np.ascontiguousarray(s),
            "offsets": np.ascontiguousarray(off), "bits": np.int8(4),
            "has_off": np.bool_(bool(np.any(off)))}


# ---------------------------------------------------------------------------
# store wrapper
# ---------------------------------------------------------------------------

class QuantizedStore:
    """Duck-types the SafetensorsStore surface the loader reads (load /
    __contains__ / names / getter) over a GPTQ/AWQ checkpoint:
    `<module>.weight` dequantizes from `<module>.{qweight,qzeros,scales}`
    when present, everything else passes through. The reference's meta
    and zeros_getter serve windowed decode, which is not ported.

    `linear`: a dense weight comes back in HF Linear's (out, in) layout,
    as the reference returns it. GPT-2's Conv1D modules keep (in, out)
    in the checkpoint, and a GPTQ/AWQ packer quantizes them as the
    (in, out) matmul RHS, so `linear=False` returns that (K, N) array
    itself. The reference transposes those too, which hands the GPT-2
    recipe (out, in) matrices: its dense path then fails on any
    non-square projection (the port's loader passes linear=False)."""

    def __init__(self, base, spec: QuantSpec, linear: bool = True):
        self.base = base
        self.spec = spec
        self.linear = linear
        self._qmods = {n[:-8] for n in base.names() if n.endswith(".qweight")}

    def _is_quant(self, name: str) -> bool:
        return name.endswith(".weight") and name[:-7] in self._qmods

    def names(self):
        # collapse ONLY the packed-quant component names of a module
        # into '<mod>.weight' — sibling tensors (e.g. '<mod>.bias')
        # share the module prefix and must keep passing through
        seen = set()
        for n in self.base.names():
            mod, _, leaf = n.rpartition(".")
            if mod in self._qmods and leaf in ("qweight", "qzeros",
                                               "scales", "g_idx"):
                if mod not in seen:
                    seen.add(mod)
                    yield mod + ".weight"
            else:
                yield n

    def __contains__(self, name):
        return name in self.base or self._is_quant(name)

    def _unpacked(self, mod: str):
        qweight = self.base.load(mod + ".qweight")
        qzeros = self.base.load(mod + ".qzeros")
        scales = np.asarray(self.base.load(mod + ".scales"),
                            dtype=np.float32)
        if self.spec.method == "gptq":
            q, z, s = unpack_gptq(qweight, qzeros, scales, self.spec)
        else:
            q, z, s = unpack_awq(qweight, qzeros, scales, self.spec)
        g_idx = None
        if (mod + ".g_idx") in self.base:
            gi = np.asarray(self.base.load(mod + ".g_idx"), np.int64)
            if not np.array_equal(gi, np.arange(q.shape[0])
                                  // self.spec.group_size):
                g_idx = gi
        return q, z, s, g_idx

    def load(self, name: str) -> np.ndarray:
        if not self._is_quant(name):
            return self.base.load(name)
        q, z, s, g_idx = self._unpacked(name[:-7])
        w = dequant_dense(q, z, s, g_idx)                 # (K, N)
        return np.ascontiguousarray(w.T if self.linear else w)

    def getter(self):
        return self.load

    def packed_source(self, name: str) -> Optional[Callable]:
        """() -> the kernel's device dict for `<module>.weight`, or
        None when ineligible (not quantized / desc_act / bad shapes)."""
        if not self._is_quant(name) or self.spec.bits != 4:
            return None

        def make():
            q, z, s, g_idx = self._unpacked(name[:-7])
            if g_idx is not None:
                return None            # act-order: the dense path
            return repack_for_kernel(q, z, s)
        return make
