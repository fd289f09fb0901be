"""STFT milli op (ONNX opset-17 semantics) and its PyTorch lowering.

Reference equivalent: the Stft symbolic op. Output layout
(batch, frames, dft_unique_bins, 2) with [..., 0]=real, [..., 1]=imag.

The class is the port's copy of whisper_tensor_tpu/milli/ops/signal.py
(numpy `eval` and shape inference; no `to_jax`). The lowering, like the
reference's `to_jax`, frames the signal by a gather of host-planned
indices, windows it and transforms each frame with torch.fft (rfft when
onesided), in f32 (f64 for an f64 signal); frame_step and frame_length
must be host values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering, need_static


@dataclass
class StftMilli(MilliOp):
    """inputs: signal(B, L) or (B, L, 1), frame_step()[, window(W), frame_length()]."""

    onesided: bool = True
    KIND = "Stft"

    def _frames(self, L, step, flen):
        return 1 + (L - flen) // step

    def eval(self, inputs):
        sig = inputs[0]
        step = int(np.asarray(inputs[1]).reshape(()))
        window = inputs[2] if len(inputs) > 2 and inputs[2] is not None else None
        flen = (int(np.asarray(inputs[3]).reshape(()))
                if len(inputs) > 3 and inputs[3] is not None
                else (window.shape[0] if window is not None else None))
        squeeze_last = sig.ndim == 3
        if squeeze_last:
            sig = sig[..., 0]
        B, L = sig.shape
        if flen is None:
            flen = L
        w = window.astype(np.float64) if window is not None else np.ones(flen)
        nf = self._frames(L, step, flen)
        idx = np.arange(flen)[None, :] + step * np.arange(nf)[:, None]
        frames = sig.astype(np.float64)[:, idx] * w  # (B, nf, flen)
        if self.onesided:
            spec = np.fft.rfft(frames, n=flen, axis=-1)
        else:
            spec = np.fft.fft(frames, n=flen, axis=-1)
        out = np.stack([spec.real, spec.imag], axis=-1)
        return [out.astype(sig.dtype)]

    def infer(self, infos):
        vals = [i.value if i is not None and i.level is Level.NUMERIC else None
                for i in infos]
        if vals[0] is not None and all(
                v is not None for k, v in enumerate(vals[1:], 1) if infos[k] is not None):
            return [TensorInfo.numeric(self.eval(vals)[0])]
        return [TensorInfo.minimal(infos[0].dtype)]


@lowering("Stft")
def _lower_stft(op, inputs, static, device):
    sig = inputs[0]
    step = int(np.asarray(need_static(static, 1, "Stft")).reshape(()))
    window = inputs[2] if len(inputs) > 2 else None
    if len(inputs) > 3 and inputs[3] is not None:
        flen = int(np.asarray(need_static(static, 3, "Stft")).reshape(()))
    else:
        flen = window.shape[0] if window is not None else None
    if sig.ndim == 3:
        sig = sig[..., 0]
    L = sig.shape[1]
    if flen is None:
        flen = L
    ct = torch.float64 if sig.dtype == torch.float64 else torch.float32
    nf = op._frames(L, step, flen)
    idx = torch.as_tensor(np.arange(flen)[None, :]
                          + step * np.arange(nf)[:, None], device=sig.device)
    frames = sig.to(ct)[:, idx]                          # (B, nf, flen)
    if window is not None:
        frames = frames * window.to(ct)
    spec = (torch.fft.rfft(frames, n=flen, dim=-1) if op.onesided
            else torch.fft.fft(frames, n=flen, dim=-1))
    return [torch.stack([spec.real, spec.imag], dim=-1).to(inputs[0].dtype)]
