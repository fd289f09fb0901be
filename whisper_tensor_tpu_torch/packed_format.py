"""GGUF block-quantization formats.

Functional equivalent of the reference's PackedFormat
(src/packed_format.rs:11-79): legacy Q4_0..Q8_1 (block 32) and K-quants
Q2_K..Q8_K (block 256), with block-size/byte math used by the GGUF
importer and the packed-tensor dequantizers.

The port's copy of whisper_tensor_tpu/packed_format.py (:13-85), whole:
all 12 formats, their block sizes and bytes, GGML_TYPE_TO_PACKED.
"""

from __future__ import annotations

import enum

QK_K = 256  # super-block size for K-quants


class PackedFormat(enum.Enum):
    Q4_0 = "q4_0"
    Q4_1 = "q4_1"
    Q5_0 = "q5_0"
    Q5_1 = "q5_1"
    Q8_0 = "q8_0"
    Q8_1 = "q8_1"
    Q2_K = "q2_k"
    Q3_K = "q3_k"
    Q4_K = "q4_k"
    Q5_K = "q5_k"
    Q6_K = "q6_k"
    Q8_K = "q8_k"

    @property
    def block_size(self) -> int:
        """Number of scalar elements per quantization block."""
        if self in (PackedFormat.Q4_0, PackedFormat.Q4_1, PackedFormat.Q5_0,
                    PackedFormat.Q5_1, PackedFormat.Q8_0, PackedFormat.Q8_1):
            return 32
        return QK_K

    @property
    def block_bytes(self) -> int:
        """Bytes of storage per block (scale/min fields + packed weights)."""
        return _BLOCK_BYTES[self]

    @property
    def bits_per_weight(self) -> float:
        return self.block_bytes * 8.0 / self.block_size

    def storage_bytes(self, n_elements: int) -> int:
        bs = self.block_size
        if n_elements % bs != 0:
            raise ValueError(f"{n_elements} not a multiple of block size {bs}")
        return (n_elements // bs) * self.block_bytes


_BLOCK_BYTES = {
    # legacy formats: fp16 scale (+ optional fp16 min) + packed nibbles/bytes
    PackedFormat.Q4_0: 2 + 16,            # d + 32*4bit
    PackedFormat.Q4_1: 2 + 2 + 16,        # d + m + 32*4bit
    PackedFormat.Q5_0: 2 + 4 + 16,        # d + qh(32bit) + 32*4bit low
    PackedFormat.Q5_1: 2 + 2 + 4 + 16,    # d + m + qh + low nibbles
    PackedFormat.Q8_0: 2 + 32,            # d + 32*int8
    PackedFormat.Q8_1: 2 + 2 + 32,        # d + s + 32*int8
    # K-quants over 256-element super-blocks
    PackedFormat.Q2_K: 16 + 64 + 2 + 2,           # scales/mins(16) + 2bit(64) + d + dmin
    PackedFormat.Q3_K: 32 + 64 + 12 + 2,          # hmask(32) + 3bit low(64) + scales(12) + d
    PackedFormat.Q4_K: 2 + 2 + 12 + 128,          # d + dmin + scales(12) + 4bit(128)
    PackedFormat.Q5_K: 2 + 2 + 12 + 32 + 128,     # d + dmin + scales + qh + 4bit low
    PackedFormat.Q6_K: 128 + 64 + 16 + 2,         # ql(128) + qh(64) + scales(16) + d
    PackedFormat.Q8_K: 4 + 256 + 32,              # d(f32) + 256*int8 + bsums(16*i16)
}

# GGML type ids (GGUF on-disk tensor type field) -> PackedFormat
GGML_TYPE_TO_PACKED = {
    2: PackedFormat.Q4_0,
    3: PackedFormat.Q4_1,
    6: PackedFormat.Q5_0,
    7: PackedFormat.Q5_1,
    8: PackedFormat.Q8_0,
    9: PackedFormat.Q8_1,
    10: PackedFormat.Q2_K,
    11: PackedFormat.Q3_K,
    12: PackedFormat.Q4_K,
    13: PackedFormat.Q5_K,
    14: PackedFormat.Q6_K,
    15: PackedFormat.Q8_K,
}
