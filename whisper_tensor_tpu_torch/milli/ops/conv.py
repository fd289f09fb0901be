"""Conv, ConvTranspose, Pool and Resize: the milli op classes and their
PyTorch lowerings.

The classes are the port's copy of whisper_tensor_tpu/milli/ops/conv.py
(numpy `eval` and shape inference, Resize's host-side gather plan
`resize_plan` and its helpers, Conv's autodiff `backward`; no `to_jax`),
with the gradient kinds that only training emits, ConvInputGrad,
ConvWeightGrad and ConvBiasGrad (:202-441), lowered by
`torch.nn.grad.conv*d_input`/`_weight` over the padded input and a sum.
ConvTranspose's numpy eval shares the input-gradient arithmetic of
ConvInputGrad, `_conv_input_grad_np`.

The lowerings are the counterparts of the reference's `to_jax`, which
computes these ops with `lax` outside any Pallas kernel; here torch's
convolutions and plain tensor ops carry them:
  * Conv and ConvTranspose: torch.nn.functional.conv{1,2,3}d and
    conv_transpose{1,2,3}d (asymmetric pads as an explicit pad or crop).
    The precision contract of `_conv_precision` (:32-42): f32 and f64
    run at full precision (TF32 is off, device.py), f16 computes in f32
    and rounds back, bf16 accumulates in f32 and rounds once (cuDNN's
    bf16 convolution on the card; f32 operands elsewhere, which give the
    same sums). The bias is added after that rounding, as the reference
    does. Integer operands (ConvInteger) accumulate exactly in int64 by
    kernel positions, as the oracle's `_np_conv` does.
  * Pool: the oracle's kernel-position loop over strided slices of the
    padded input (max, or an f32 sum over the window's element count),
    and MaxPool's Indices output, which the reference leaves to its
    oracle.
  * Resize: the reference's plan (`Resize._plan`, from host values of
    roi, scales and sizes), applied on the device axis by axis as a
    gather and an f32 weighted sum, so every ONNX coordinate mode gives
    the reference's indices and weights bit for bit.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...dtype import DType
from ...scalar_info import ScalarInfo
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp, Phase
from ..registry import lowering, need_static
from .common import downcast_result, upcast_for_compute


def _conv_out_size(in_size, k, stride, dil, pad_begin, pad_end):
    eff_k = (k - 1) * dil + 1
    return (in_size + pad_begin + pad_end - eff_k) // stride + 1


def _np_conv(x, w, bias, strides, pads, dilations, groups):
    """x: (N, Cin, *sp); w: (Cout, Cin/g, *k). pads: [b0..bn, e0..en]."""
    nsp = x.ndim - 2
    strides = list(strides or [1] * nsp)
    dilations = list(dilations or [1] * nsp)
    pads = list(pads or [0] * (2 * nsp))
    pb, pe = pads[:nsp], pads[nsp:]
    xp = np.pad(x, [(0, 0), (0, 0)] + [(pb[i], pe[i]) for i in range(nsp)])
    N, Cin = x.shape[:2]
    Cout = w.shape[0]
    ksp = w.shape[2:]
    osp = [_conv_out_size(x.shape[2 + i], ksp[i], strides[i], dilations[i], pb[i], pe[i])
           for i in range(nsp)]
    icg = Cin // groups
    ocg = Cout // groups
    out = np.zeros((N, Cout, *osp), dtype=x.dtype)
    for kpos in itertools.product(*[range(k) for k in ksp]):
        sl = tuple(
            slice(kpos[i] * dilations[i],
                  kpos[i] * dilations[i] + strides[i] * (osp[i] - 1) + 1,
                  strides[i])
            for i in range(nsp))
        xs = xp[(slice(None), slice(None)) + sl]  # (N, Cin, *osp)
        wk = w[(slice(None), slice(None)) + kpos]  # (Cout, icg)
        if groups == 1:
            out += np.einsum("nc...,oc->no...", xs, wk)
        else:
            xs_g = xs.reshape(N, groups, icg, *osp)
            wk_g = wk.reshape(groups, ocg, icg)
            og = np.einsum("ngc...,goc->ngo...", xs_g, wk_g)
            out += og.reshape(N, Cout, *osp)
    if bias is not None:
        out += bias.reshape((1, -1) + (1,) * nsp)
    return out


@dataclass
class Conv(MilliOp):
    """inputs: x, w[, bias]. Explicit pads, or auto_pad SAME_UPPER /
    SAME_LOWER resolved here from the runtime shapes."""

    strides: Optional[List[int]] = None
    pads: Optional[List[int]] = None
    dilations: Optional[List[int]] = None
    groups: int = 1
    auto_pad: str = "NOTSET"
    KIND = "Conv"

    def _pads(self, x_shape, w_shape):
        if self.auto_pad not in ("SAME_UPPER", "SAME_LOWER"):
            return self.pads
        nsp = len(x_shape) - 2
        s = list(self.strides or [1] * nsp)
        d = list(self.dilations or [1] * nsp)
        k = list(w_shape[2:])
        pb, pe = [], []
        for i in range(nsp):
            eff = (k[i] - 1) * d[i] + 1
            o = -(-x_shape[2 + i] // s[i])
            total = max((o - 1) * s[i] + eff - x_shape[2 + i], 0)
            small, big = total // 2, total - total // 2
            if self.auto_pad == "SAME_UPPER":
                pb.append(small)
                pe.append(big)
            else:
                pb.append(big)
                pe.append(small)
        return pb + pe

    def eval(self, inputs):
        x, w = inputs[0], inputs[1]
        bias = inputs[2] if len(inputs) > 2 and inputs[2] is not None else None
        xc, orig = upcast_for_compute(x)
        wc, _ = upcast_for_compute(w)
        bc = upcast_for_compute(bias)[0] if bias is not None else None
        out = _np_conv(xc, wc, bc, self.strides,
                       self._pads(x.shape, w.shape), self.dilations,
                       self.groups)
        return [downcast_result(out, orig)]

    def infer(self, infos):
        x, w = infos[0], infos[1]
        if all(i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        dx, dw = x.dims(), w.dims()
        if dx is not None and dw is not None:
            nsp = len(dx) - 2
            strides = self.strides or [1] * nsp
            dil = self.dilations or [1] * nsp
            if self.auto_pad in ("SAME_UPPER", "SAME_LOWER") and \
                    all(d.is_known for d in list(dx) + list(dw)):
                pads = list(self._pads([int(d.value()) for d in dx],
                                       [int(d.value()) for d in dw]))
            else:
                pads = list(self.pads or [0] * (2 * nsp))
            out = [dx[0], dw[0]]
            for i in range(nsp):
                if dx[2 + i].is_known and dw[2 + i].is_known:
                    out.append(ScalarInfo.of(_conv_out_size(
                        int(dx[2 + i].value()), int(dw[2 + i].value()),
                        strides[i], dil[i], pads[i], pads[i + nsp])))
                else:
                    return [TensorInfo.ranked(x.dtype, len(dx))]
            return [TensorInfo.shaped(x.dtype, out)]
        if x.rank is not None:
            return [TensorInfo.ranked(x.dtype, x.rank)]
        return [TensorInfo.minimal(x.dtype)]

    def backward(self, b, node, out_grads):
        g = out_grads[0]
        if g is None:
            return [None] * len(node.inputs)
        P = Phase.BACKWARD
        from .shape import Shape

        x, w = node.inputs[0], node.inputs[1]
        xs = b.op1(Shape(), x, phase=P)
        ws = b.op1(Shape(), w, phase=P)
        gx = b.op1(ConvInputGrad(self.strides, self.pads, self.dilations, self.groups),
                   xs, w, g, phase=P)
        gw = b.op1(ConvWeightGrad(self.strides, self.pads, self.dilations, self.groups),
                   ws, x, g, phase=P)
        grads = [gx, gw]
        if len(node.inputs) > 2:
            gb = b.op1(ConvBiasGrad(), g, phase=P)
            grads.append(gb)
        return grads


@dataclass
class ConvInputGrad(MilliOp):
    """(x_shape, w, grad) -> dX. Transposed convolution of grad by w."""

    strides: Optional[List[int]] = None
    pads: Optional[List[int]] = None
    dilations: Optional[List[int]] = None
    groups: int = 1
    KIND = "ConvInputGrad"

    def eval(self, inputs):
        x_shape = tuple(int(v) for v in np.asarray(inputs[0]).reshape(-1))
        w, g = inputs[1], inputs[2]
        wc, _ = upcast_for_compute(w)
        gc, orig = upcast_for_compute(g)
        return [downcast_result(_conv_input_grad_np(
            x_shape, wc, gc, self.strides, self.pads, self.dilations,
            self.groups), orig)]

    def infer(self, infos):
        shp = infos[0]
        dt = infos[2].dtype
        if shp.level is Level.NUMERIC:
            return [TensorInfo.shaped(dt, [int(v) for v in shp.value.reshape(-1)])]
        return [TensorInfo.minimal(dt)]


@dataclass
class ConvWeightGrad(MilliOp):
    """(w_shape, x, grad) -> dW."""

    strides: Optional[List[int]] = None
    pads: Optional[List[int]] = None
    dilations: Optional[List[int]] = None
    groups: int = 1
    KIND = "ConvWeightGrad"

    def eval(self, inputs):
        w_shape = tuple(int(v) for v in np.asarray(inputs[0]).reshape(-1))
        x, g = inputs[1], inputs[2]
        xc, _ = upcast_for_compute(x)
        gc, orig = upcast_for_compute(g)
        nsp = x.ndim - 2
        strides = list(self.strides or [1] * nsp)
        dil = list(self.dilations or [1] * nsp)
        pads = list(self.pads or [0] * (2 * nsp))
        pb, pe = pads[:nsp], pads[nsp:]
        xp = np.pad(xc, [(0, 0), (0, 0)] + [(pb[i], pe[i]) for i in range(nsp)])
        N, Cin = x.shape[:2]
        Cout = w_shape[0]
        icg = Cin // self.groups
        ocg = Cout // self.groups
        ksp = w_shape[2:]
        osp = gc.shape[2:]
        dw = np.zeros(w_shape, dtype=gc.dtype)
        for kpos in itertools.product(*[range(k) for k in ksp]):
            sl = tuple(
                slice(kpos[i] * dil[i],
                      kpos[i] * dil[i] + strides[i] * (osp[i] - 1) + 1,
                      strides[i])
                for i in range(nsp))
            xs = xp[(slice(None), slice(None)) + sl]  # (N, Cin, *osp)
            sp = "defgh"[:nsp]  # spatial index letters (reduced)
            if self.groups == 1:
                dw[(slice(None), slice(None)) + kpos] += np.einsum(
                    f"no{sp},nc{sp}->oc", gc, xs)
            else:
                g_g = gc.reshape(N, self.groups, ocg, *osp)
                xs_g = xs.reshape(N, self.groups, icg, *osp)
                dd = np.einsum(f"ngo{sp},ngc{sp}->goc", g_g, xs_g).reshape(Cout, icg)
                dw[(slice(None), slice(None)) + kpos] += dd
        return [downcast_result(dw, orig)]

    def infer(self, infos):
        shp = infos[0]
        dt = infos[2].dtype
        if shp.level is Level.NUMERIC:
            return [TensorInfo.shaped(dt, [int(v) for v in shp.value.reshape(-1)])]
        return [TensorInfo.minimal(dt)]


@dataclass
class ConvBiasGrad(MilliOp):
    """grad -> dBias (sum over all but channel axis 1)."""

    KIND = "ConvBiasGrad"

    def eval(self, inputs):
        g = inputs[0]
        gc, orig = upcast_for_compute(g)
        ax = (0,) + tuple(range(2, g.ndim))
        return [downcast_result(gc.sum(axis=ax), orig)]

    def infer(self, infos):
        i = infos[0]
        dims = i.dims()
        if dims is not None:
            return [TensorInfo.shaped(i.dtype, [dims[1]])]
        return [TensorInfo.ranked(i.dtype, 1)]


def _conv_input_grad_np(x_shape, w, g, strides, pads, dilations, groups):
    """The reference's ConvInputGrad._compute_np (:211-240): the
    transposed convolution of g by w, cropped to x_shape."""
    nsp = len(x_shape) - 2
    strides = list(strides or [1] * nsp)
    dil = list(dilations or [1] * nsp)
    pads = list(pads or [0] * (2 * nsp))
    pb, pe = pads[:nsp], pads[nsp:]
    N, Cin = x_shape[0], x_shape[1]
    Cout = w.shape[0]
    ksp = w.shape[2:]
    osp = g.shape[2:]
    icg = Cin // groups
    ocg = Cout // groups
    padded_shape = [x_shape[2 + i] + pb[i] + pe[i] for i in range(nsp)]
    dxp = np.zeros((N, Cin, *padded_shape), dtype=g.dtype)
    for kpos in itertools.product(*[range(k) for k in ksp]):
        wk = w[(slice(None), slice(None)) + kpos]  # (Cout, icg)
        if groups == 1:
            contrib = np.einsum("no...,oc->nc...", g, wk)  # (N, Cin, *osp)
        else:
            g_g = g.reshape(N, groups, ocg, *osp)
            wk_g = wk.reshape(groups, ocg, icg)
            contrib = np.einsum("ngo...,goc->ngc...", g_g, wk_g).reshape(N, Cin, *osp)
        sl = tuple(
            slice(kpos[i] * dil[i],
                  kpos[i] * dil[i] + strides[i] * (osp[i] - 1) + 1,
                  strides[i])
            for i in range(nsp))
        dxp[(slice(None), slice(None)) + sl] += contrib
    unpad = tuple(slice(pb[i], pb[i] + x_shape[2 + i]) for i in range(nsp))
    return dxp[(slice(None), slice(None)) + unpad]


# ---------------------------------------------------------------------------
# Resize
# ---------------------------------------------------------------------------


def _orig_coord(out_idx: np.ndarray, scale: float, in_size: int, out_size: int,
                mode: str) -> np.ndarray:
    x = out_idx.astype(np.float64)
    if mode == "half_pixel":
        return (x + 0.5) / scale - 0.5
    if mode == "pytorch_half_pixel":
        return (x + 0.5) / scale - 0.5 if out_size > 1 else np.zeros_like(x)
    if mode == "align_corners":
        if out_size == 1:
            return np.zeros_like(x)
        return x * (in_size - 1) / (out_size - 1)
    if mode == "asymmetric":
        return x / scale
    if mode == "half_pixel_symmetric":
        adjustment = out_size / (scale * in_size)
        center = in_size / 2.0
        offset = center * (1 - adjustment)
        return offset + (x + 0.5) / scale - 0.5
    raise NotImplementedError(f"coordinate_transformation_mode {mode}")


def _nearest_pick(coord: np.ndarray, mode: str) -> np.ndarray:
    if mode == "round_prefer_floor":
        return np.ceil(coord - 0.5)
    if mode == "round_prefer_ceil":
        return np.floor(coord + 0.5)
    if mode == "floor":
        return np.floor(coord)
    if mode == "ceil":
        return np.ceil(coord)
    raise NotImplementedError(f"nearest_mode {mode}")


def _cubic_weights(t: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic kernel weights for offsets [-1,0,1,2] around floor(coord)."""
    # t in [0,1): fractional part
    w = np.empty(t.shape + (4,), dtype=np.float64)
    for i, off in enumerate((-1, 0, 1, 2)):
        x = np.abs(t - off)
        w[..., i] = np.where(
            x <= 1, ((a + 2) * x - (a + 3)) * x * x + 1,
            np.where(x < 2, ((a * x - 5 * a) * x + 8 * a) * x - 4 * a, 0.0))
    return w


def _cubic_kernel(x, a):
    x = np.abs(x)
    return np.where(
        x <= 1.0, (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0,
        np.where(x < 2.0,
                 a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a,
                 0.0))


def _antialias_plan(coord, in_size, scale, mode, cubic_a, exclude_outside):
    """Downscale antialias filter (ONNX-18 antialias=1): the kernel is
    stretched by 1/scale and every output taps a fixed footprint of
    inputs, weights normalized to sum 1 (edge-replicated borders)."""
    s = min(float(scale), 1.0)
    reach = 1.0 if mode == "linear" else 2.0
    i_start = int(np.floor(-reach / s)) + 1
    i_end = int(2 * reach) - i_start if mode == "cubic" else 2 - 2 * i_start
    # footprint: relative taps [i_start, i_end)
    if mode == "cubic":
        i_end = 2 - i_start
        rel = np.arange(i_start, i_end)
    else:
        rel = np.arange(i_start, i_start + (2 - 2 * i_start))
    lo = np.floor(coord).astype(np.int64)
    ratio = coord - lo
    args = (rel[None, :] - ratio[:, None]) * s
    if mode == "linear":
        w = np.clip(1.0 - np.abs(args), 0.0, 1.0)
    else:
        w = _cubic_kernel(args, cubic_a)
    idx = lo[:, None] + rel[None, :]
    if exclude_outside:
        inside = (idx >= 0) & (idx < in_size)
        w = np.where(inside, w, 0.0)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return np.clip(idx, 0, in_size - 1), w


def resize_plan(in_size: int, out_size: int, scale: float, mode: str,
                coord_mode: str, nearest_mode: str, cubic_a: float,
                exclude_outside: bool, antialias: bool = False,
                roi_ax=None):
    """Host-side gather plan for one axis: (indices (out,k), weights
    (out,k), extrapolation mask (out,) or None)."""
    out_idx = np.arange(out_size)
    if coord_mode == "tf_crop_and_resize":
        start, end = float(roi_ax[0]), float(roi_ax[1])
        x = out_idx.astype(np.float64)
        if out_size > 1:
            coord = (start * (in_size - 1)
                     + x * (end - start) * (in_size - 1) / (out_size - 1))
        else:
            coord = np.full_like(x, 0.5 * (start + end) * (in_size - 1))
        extrap = ~((coord >= 0) & (coord <= in_size - 1))
    else:
        coord = _orig_coord(out_idx, scale, in_size, out_size, coord_mode)
        extrap = None
    if antialias and mode in ("linear", "cubic") and scale < 1.0:
        idx, w = _antialias_plan(coord, in_size, scale, mode, cubic_a,
                                 exclude_outside)
        return idx, w, extrap
    if mode == "nearest":
        idx = _nearest_pick(coord, nearest_mode).astype(np.int64)
        idx = np.clip(idx, 0, in_size - 1)
        return idx[:, None], np.ones((out_size, 1)), extrap
    if mode == "linear":
        lo = np.floor(coord).astype(np.int64)
        t = coord - lo
        idx = np.stack([lo, lo + 1], axis=1)
        w = np.stack([1 - t, t], axis=1)
        idx_c = np.clip(idx, 0, in_size - 1)
        return idx_c, w, extrap
    if mode == "cubic":
        lo = np.floor(coord).astype(np.int64)
        t = coord - lo
        w = _cubic_weights(t, cubic_a)
        idx = np.stack([lo - 1, lo, lo + 1, lo + 2], axis=1)
        if exclude_outside:
            inside = (idx >= 0) & (idx < in_size)
            w = np.where(inside, w, 0.0)
            w = w / w.sum(axis=1, keepdims=True)
        idx_c = np.clip(idx, 0, in_size - 1)
        return idx_c, w, extrap
    raise NotImplementedError(f"resize mode {mode}")


@dataclass
class Resize(MilliOp):
    """inputs: x, roi?, scales?, sizes? (exactly one of scales/sizes set;
    empty tensors mean absent, per ONNX)."""

    mode: str = "nearest"
    coord_mode: str = "half_pixel"
    nearest_mode: str = "round_prefer_floor"
    cubic_a: float = -0.75
    exclude_outside: bool = False
    axes: Optional[List[int]] = None
    antialias: bool = False
    keep_policy: str = "stretch"   # keep_aspect_ratio_policy
    extrapolation_value: float = 0.0
    KIND = "Resize"

    def _plan(self, in_shape, scales, sizes, roi=None):
        rank = len(in_shape)
        axes = self.axes if self.axes else list(range(rank))
        axes = [a % rank for a in axes]
        out_shape = list(in_shape)
        per_axis = {}
        if sizes is not None and np.asarray(sizes).size:
            sizes = [int(s) for s in np.asarray(sizes).reshape(-1)]
            if self.keep_policy in ("not_larger", "not_smaller"):
                cands = [s / in_shape[a] for a, s in zip(axes, sizes)]
                sc = (min(cands) if self.keep_policy == "not_larger"
                      else max(cands))
                for a in axes:
                    o = int(round(sc * in_shape[a]))
                    out_shape[a] = o
                    per_axis[a] = (o, sc)
            else:
                for a, s in zip(axes, sizes):
                    out_shape[a] = s
                    per_axis[a] = (s, s / in_shape[a])
        else:
            scales = np.asarray(scales).reshape(-1).astype(np.float64)
            for a, sc in zip(axes, scales):
                o = int(np.floor(in_shape[a] * sc))
                out_shape[a] = o
                per_axis[a] = (o, sc)
        roi_per_axis = {}
        if self.coord_mode == "tf_crop_and_resize":
            r = (np.asarray(roi, dtype=np.float64).reshape(-1)
                 if roi is not None and np.asarray(roi).size
                 else np.concatenate([np.zeros(len(axes)),
                                      np.ones(len(axes))]))
            for i, a in enumerate(axes):
                roi_per_axis[a] = (r[i], r[len(axes) + i])
        plans = {}
        for a, (o, sc) in per_axis.items():
            if (o == in_shape[a] and abs(sc - 1.0) < 1e-9
                    and self.coord_mode != "tf_crop_and_resize"):
                continue
            plans[a] = resize_plan(in_shape[a], o, sc, self.mode,
                                   self.coord_mode, self.nearest_mode,
                                   self.cubic_a, self.exclude_outside,
                                   self.antialias,
                                   roi_per_axis.get(a, (0.0, 1.0)))
        return tuple(out_shape), plans

    def _apply(self, xp, x, plans, f32=False):
        out = x
        for a, (idx, w, extrap) in plans.items():
            gathered = xp.take(out, xp.asarray(idx.reshape(-1)), axis=a)
            new_shape = out.shape[:a] + idx.shape + out.shape[a + 1:]
            gathered = gathered.reshape(new_shape)
            wv = w.reshape((1,) * a + w.shape + (1,) * (out.ndim - a - 1))
            if f32:
                wb = xp.asarray(wv, dtype=np.float32)
                out = (gathered.astype(np.float32) * wb).sum(axis=a + 1)
            else:
                wb = xp.asarray(wv)
                out = (gathered * wb).sum(axis=a + 1)
            if extrap is not None and extrap.any():
                ev = xp.asarray(np.float32(self.extrapolation_value)
                                if f32 else self.extrapolation_value)
                eb = xp.asarray(extrap.reshape(
                    (1,) * a + extrap.shape + (1,) * (out.ndim - a - 1)))
                out = xp.where(eb, ev.astype(out.dtype), out)
        return out

    def eval(self, inputs):
        x = inputs[0]
        roi = inputs[1] if len(inputs) > 1 else None
        scales = inputs[2] if len(inputs) > 2 else None
        sizes = inputs[3] if len(inputs) > 3 else None
        xc, orig = upcast_for_compute(x)
        out_shape, plans = self._plan(x.shape, scales, sizes, roi)
        out = self._apply(np, xc, plans)
        if self.mode == "nearest":
            out = out.astype(xc.dtype)
        out = out.astype(xc.dtype, copy=False)
        return [downcast_result(out, orig)]

    def infer(self, infos):
        vals = [i.value if i is not None and i.level is Level.NUMERIC else None for i in infos]
        x = infos[0]
        if all(v is not None or infos[k] is None
               for k, v in enumerate(vals)) and vals[0] is not None:
            return [TensorInfo.numeric(self.eval(vals)[0])]
        cs = x.concrete_shape()
        scales = vals[2] if len(vals) > 2 else None
        sizes = vals[3] if len(vals) > 3 else None
        if cs is not None and (scales is not None or sizes is not None):
            out_shape, _ = self._plan(cs, scales, sizes,
                                      vals[1] if len(vals) > 1 else None)
            return [TensorInfo.shaped(x.dtype, list(out_shape))]
        if x.rank is not None:
            return [TensorInfo.ranked(x.dtype, x.rank)]
        return [TensorInfo.minimal(x.dtype)]


@dataclass
class ConvTransposeMilli(MilliOp):
    """ConvTranspose: x(N,Cin,*sp), w(Cin, Cout/g, *k)[, bias(Cout)].

    Implemented as the input-gradient of a forward conv (identical math):
    reference src/symbolic_graph/ops/mod.rs ConvTranspose.
    """

    strides: Optional[List[int]] = None
    pads: Optional[List[int]] = None
    dilations: Optional[List[int]] = None
    groups: int = 1
    output_padding: Optional[List[int]] = None
    KIND = "ConvTranspose"

    def _out_shape(self, x_shape, w_shape):
        nsp = len(x_shape) - 2
        strides = list(self.strides or [1] * nsp)
        dil = list(self.dilations or [1] * nsp)
        pads = list(self.pads or [0] * (2 * nsp))
        opad = list(self.output_padding or [0] * nsp)
        cout = w_shape[1] * self.groups
        sp = [
            (x_shape[2 + i] - 1) * strides[i] + (w_shape[2 + i] - 1) * dil[i] + 1
            - pads[i] - pads[i + nsp] + opad[i]
            for i in range(nsp)
        ]
        return (x_shape[0], cout, *sp)

    def eval(self, inputs):
        x, w = inputs[0], inputs[1]
        out_shape = self._out_shape(x.shape, w.shape)
        xc, orig = upcast_for_compute(x)
        wc, _ = upcast_for_compute(w)
        out = _conv_input_grad_np(out_shape, wc, xc, self.strides,
                                  self.pads, self.dilations, self.groups)
        if len(inputs) > 2 and inputs[2] is not None:
            bc, _ = upcast_for_compute(inputs[2])
            out = out + bc.reshape((1, -1) + (1,) * (out.ndim - 2))
        return [downcast_result(out, orig)]

    def infer(self, infos):
        x, w = infos[0], infos[1]
        vals = [i.value if i is not None and i.level is Level.NUMERIC else None
                for i in infos]
        if all(v is not None for v in vals):
            return [TensorInfo.numeric(self.eval(vals)[0])]
        cx, cw = x.concrete_shape(), w.concrete_shape()
        if cx is not None and cw is not None:
            return [TensorInfo.shaped(x.dtype, list(self._out_shape(cx, cw)))]
        if x.rank is not None:
            return [TensorInfo.ranked(x.dtype, x.rank)]
        return [TensorInfo.minimal(x.dtype)]


@dataclass
class Pool(MilliOp):
    """MaxPool / AveragePool (+ Global* when kernel is None).

    Reference seam: the ONNX pooling family from the official node-test
    corpus (tests/onnx_testing.rs registers them); TPU lowering uses
    jax.lax.reduce_window, which XLA maps onto the vector units.
    Semantics follow ONNX/torch: ceil_mode windows must start inside
    the (left-padded) input; avg denominators honor count_include_pad
    (padding from ceil extension never counts).
    """

    mode: str = "max"                        # max | avg
    kernel: Optional[List[int]] = None       # None = global (all spatial)
    strides: Optional[List[int]] = None
    pads: Optional[List[int]] = None         # [b..., e...]
    dilations: Optional[List[int]] = None    # max only (ONNX)
    ceil_mode: bool = False
    count_include_pad: bool = False
    auto_pad: str = "NOTSET"                 # SAME_UPPER | SAME_LOWER
    n_out: int = 1                           # 2 = MaxPool Indices output
    storage_order: int = 0                   # Indices flattening order
    KIND = "Pool"

    def _geometry(self, ishape):
        nsp = len(ishape) - 2
        k = list(self.kernel) if self.kernel else list(ishape[2:])
        s = list(self.strides or [1] * nsp)
        d = list(self.dilations or [1] * nsp)
        pads = list(self.pads or [0] * (2 * nsp))
        pb, pe = pads[:nsp], pads[nsp:]
        if self.auto_pad in ("SAME_UPPER", "SAME_LOWER"):
            pb, pe = [], []
            for i in range(nsp):
                eff = (k[i] - 1) * d[i] + 1
                o = -(-ishape[2 + i] // s[i])
                total = max((o - 1) * s[i] + eff - ishape[2 + i], 0)
                small, big = total // 2, total - total // 2
                if self.auto_pad == "SAME_UPPER":
                    pb.append(small)
                    pe.append(big)
                else:
                    pb.append(big)
                    pe.append(small)
        osp, pe_ext = [], []
        for i in range(nsp):
            eff = (k[i] - 1) * d[i] + 1
            num = ishape[2 + i] + pb[i] + pe[i] - eff
            o = (-(-num // s[i]) if self.ceil_mode else num // s[i]) + 1
            if self.ceil_mode and (o - 1) * s[i] >= ishape[2 + i] + pb[i]:
                o -= 1
            osp.append(o)
            # extend end padding so every window slice exists
            pe_ext.append(max(pe[i], (o - 1) * s[i] + eff
                              - ishape[2 + i] - pb[i]))
        return k, s, d, pb, pe, pe_ext, osp

    def eval(self, inputs):
        x = inputs[0]
        nsp = x.ndim - 2
        k, s, d, pb, pe, pe_ext, osp = self._geometry(x.shape)
        xc, orig = upcast_for_compute(x)
        if self.mode == "max":
            fill = (np.array(-np.inf, dtype=xc.dtype) if xc.dtype.kind == "f"
                    else np.iinfo(xc.dtype).min)
        else:
            fill = 0
        xp = np.pad(xc, [(0, 0), (0, 0)] + [(pb[i], pe_ext[i])
                                            for i in range(nsp)],
                    constant_values=fill)
        out = None
        for kpos in itertools.product(*[range(ki) for ki in k]):
            sl = tuple(slice(kpos[i] * d[i],
                             kpos[i] * d[i] + s[i] * (osp[i] - 1) + 1, s[i])
                       for i in range(nsp))
            w = xp[(slice(None), slice(None)) + sl]
            if out is None:
                out = w.copy()
            elif self.mode == "max":
                out = np.maximum(out, w)
            else:
                out = out + w
        if self.mode == "avg":
            out = out / self._denom(x.shape, np)
        y = downcast_result(out.astype(xc.dtype, copy=False), orig)
        if self.n_out < 2:
            return [y]
        # MaxPool Indices: flattened position of each window max in the
        # ORIGINAL input (row-major; storage_order=1 flattens spatial
        # dims column-major). Loop form — the Indices surface is an
        # oracle artifact (corpus argmax tests), not a serving path.
        N, C = x.shape[0], x.shape[1]
        sp = x.shape[2:]
        idx_out = np.zeros((N, C) + tuple(osp), np.int64)
        for n in range(N):
            for c in range(C):
                for opos in itertools.product(*[range(o) for o in osp]):
                    best, best_i = None, 0
                    for kpos in itertools.product(*[range(ki) for ki in k]):
                        ipos = [opos[i] * s[i] - pb[i] + kpos[i] * d[i]
                                for i in range(nsp)]
                        if any(p_ < 0 or p_ >= sp[i]
                               for i, p_ in enumerate(ipos)):
                            continue
                        v = x[(n, c) + tuple(ipos)]
                        if best is None or v > best:
                            best = v
                            if self.storage_order == 1 and nsp == 2:
                                flat_sp = ipos[1] * sp[0] + ipos[0]
                            else:
                                flat_sp = 0
                                for i in range(nsp):
                                    flat_sp = flat_sp * sp[i] + ipos[i]
                            spn = 1
                            for dim in sp:
                                spn *= dim
                            best_i = (n * C + c) * spn + flat_sp
                    idx_out[(n, c) + opos] = best_i
        return [y, idx_out]

    def _denom(self, ishape, xp_mod):
        """per-window element count (f32): ones over the input, 1-padded
        in the declared pads iff count_include_pad, always 0-padded in
        the ceil extension."""
        nsp = len(ishape) - 2
        k, s, d, pb, pe, pe_ext, osp = self._geometry(ishape)
        ones = np.ones(ishape[2:], dtype=np.float32)
        inc = 1.0 if self.count_include_pad else 0.0
        cnt = np.pad(ones, [(pb[i], pe[i]) for i in range(nsp)],
                     constant_values=inc)
        cnt = np.pad(cnt, [(0, pe_ext[i] - pe[i]) for i in range(nsp)],
                     constant_values=0.0)
        den = None
        for kpos in itertools.product(*[range(ki) for ki in k]):
            sl = tuple(slice(kpos[i] * d[i],
                             kpos[i] * d[i] + s[i] * (osp[i] - 1) + 1, s[i])
                       for i in range(nsp))
            w = cnt[sl]
            den = w.copy() if den is None else den + w
        den = den[(None, None)]
        return xp_mod.asarray(den) if xp_mod is not np else den

    def infer(self, infos):
        i = infos[0]
        if i.level is Level.NUMERIC:
            return [TensorInfo.numeric(o) for o in self.eval([i.value])]
        cs = i.concrete_shape()
        if cs is not None:
            _, _, _, _, _, _, osp = self._geometry(cs)
            out = TensorInfo.shaped(i.dtype, list(cs[:2]) + osp)
            return [out, TensorInfo.shaped(DType.I64, list(cs[:2]) + osp)
                    ][:self.n_out]
        if i.rank is not None:
            return [TensorInfo.ranked(i.dtype, i.rank),
                    TensorInfo.ranked(DType.I64, i.rank)][:self.n_out]
        return [TensorInfo.minimal(i.dtype),
                TensorInfo.minimal(DType.I64)][:self.n_out]

# -- lowerings ----------------------------------------------------------

_CONV_FNS = {1: (F.conv1d, F.conv_transpose1d),
             2: (F.conv2d, F.conv_transpose2d),
             3: (F.conv3d, F.conv_transpose3d)}
_GRAD_FNS = {1: (torch.nn.grad.conv1d_input, torch.nn.grad.conv1d_weight),
             2: (torch.nn.grad.conv2d_input, torch.nn.grad.conv2d_weight),
             3: (torch.nn.grad.conv3d_input, torch.nn.grad.conv3d_weight)}


def _compute_pair(x: torch.Tensor, w: torch.Tensor):
    """(x, w) in the type a float convolution runs in: bf16 stays bf16 on
    the card (cuDNN accumulates it in f32); f16, and bf16 elsewhere, go
    to f32 (f32 sums of exact products, rounded once by the caller)."""
    if x.dtype == torch.bfloat16 and x.device.type == "cuda":
        return x, w.to(x.dtype)
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float(), w.float()
    return x, w.to(x.dtype)


def _pad_spatial(x: torch.Tensor, begin, end, value=0.0) -> torch.Tensor:
    """Pad (or, for negative amounts, crop) the spatial axes 2.. of x."""
    amounts = []
    for b, e in zip(reversed(begin), reversed(end)):
        amounts += [int(b), int(e)]
    if not any(amounts):
        return x
    return F.pad(x, amounts, value=value)


def _window(xp: torch.Tensor, kpos, d, s, osp) -> torch.Tensor:
    """xp[..., kpos*d :: s] over osp outputs on every spatial axis."""
    sl = tuple(slice(kpos[i] * d[i], kpos[i] * d[i] + s[i] * (osp[i] - 1) + 1,
                     s[i]) for i in range(len(osp)))
    return xp[(slice(None), slice(None)) + sl]


def _int_conv(x, w, strides, pads, dilations, groups) -> torch.Tensor:
    """An integer convolution summed exactly in int64 by kernel
    positions (the oracle's _np_conv), in x's type."""
    nsp = x.ndim - 2
    s = list(strides or [1] * nsp)
    d = list(dilations or [1] * nsp)
    pads = list(pads or [0] * (2 * nsp))
    xp = _pad_spatial(x.long(), pads[:nsp], pads[nsp:])
    wl = w.long()
    N, Cin = x.shape[:2]
    Cout, icg = w.shape[0], w.shape[1]
    ksp = w.shape[2:]
    osp = [_conv_out_size(x.shape[2 + i], ksp[i], s[i], d[i], pads[i],
                          pads[i + nsp]) for i in range(nsp)]
    out = torch.zeros((N, groups, Cout // groups, *osp), dtype=torch.int64,
                      device=x.device)
    for kpos in itertools.product(*[range(k) for k in ksp]):
        xs = _window(xp, kpos, d, s, osp).reshape(N, groups, 1, icg, *osp)
        wk = wl[(slice(None), slice(None)) + kpos].reshape(
            1, groups, Cout // groups, icg, *([1] * nsp))
        out += (xs * wk).sum(dim=3)
    return out.reshape(N, Cout, *osp).to(x.dtype)


def _add_bias(out: torch.Tensor, bias) -> torch.Tensor:
    if bias is None:
        return out
    return out + bias.to(out.dtype).reshape((1, -1) + (1,) * (out.ndim - 2))


@lowering("Conv")
def conv(op, inputs, static, device):
    x, w = inputs[0], inputs[1]
    bias = inputs[2] if len(inputs) > 2 else None
    nsp = x.ndim - 2
    pads = list(op._pads(tuple(x.shape), tuple(w.shape)) or [0] * (2 * nsp))
    if not x.is_floating_point():
        return [_add_bias(_int_conv(x, w, op.strides, pads, op.dilations,
                                    op.groups), bias)]
    if nsp not in _CONV_FNS:
        raise NotImplementedError(f"Conv over {nsp} spatial axes")
    xc, wc = _compute_pair(x, w)
    sym = pads[:nsp] == pads[nsp:]
    if not sym:
        xc = _pad_spatial(xc, pads[:nsp], pads[nsp:])
    out = _CONV_FNS[nsp][0](
        xc, wc, None, stride=tuple(op.strides or [1] * nsp),
        padding=tuple(pads[:nsp]) if sym else 0,
        dilation=tuple(op.dilations or [1] * nsp), groups=op.groups)
    return [_add_bias(out.to(x.dtype), bias)]


def _grad_geometry(op, nsp: int):
    """(strides, dilations, begin pads, end pads) of a gradient kind."""
    pads = list(op.pads or [0] * (2 * nsp))
    return (tuple(op.strides or [1] * nsp), tuple(op.dilations or [1] * nsp),
            pads[:nsp], pads[nsp:])


def _grad_compute(t: torch.Tensor) -> torch.Tensor:
    """A gradient kind's operand in f32 where it is a 16-bit float: the
    oracle sums in f32 and rounds once."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


@lowering("ConvInputGrad")
def conv_input_grad(op, inputs, static, device):
    x_shape = [int(v) for v in need_static(static, 0, "ConvInputGrad")
               .reshape(-1)]
    w, g = inputs[1], inputs[2]
    nsp = len(x_shape) - 2
    if nsp not in _GRAD_FNS:
        raise NotImplementedError(f"ConvInputGrad over {nsp} spatial axes")
    s, d, pb, pe = _grad_geometry(op, nsp)
    # the gradient of the padded input, cropped to x: asymmetric pads
    # are then no special case
    padded = x_shape[:2] + [x_shape[2 + i] + pb[i] + pe[i]
                            for i in range(nsp)]
    gc = _grad_compute(g)
    dxp = _GRAD_FNS[nsp][0](padded, _grad_compute(w).to(gc.dtype), gc,
                            stride=s, padding=0, dilation=d, groups=op.groups)
    return [_pad_spatial(dxp, [-p for p in pb], [-p for p in pe]).to(g.dtype)]


@lowering("ConvWeightGrad")
def conv_weight_grad(op, inputs, static, device):
    w_shape = [int(v) for v in need_static(static, 0, "ConvWeightGrad")
               .reshape(-1)]
    x, g = inputs[1], inputs[2]
    nsp = x.ndim - 2
    if nsp not in _GRAD_FNS:
        raise NotImplementedError(f"ConvWeightGrad over {nsp} spatial axes")
    s, d, pb, pe = _grad_geometry(op, nsp)
    gc = _grad_compute(g)
    xp = _pad_spatial(_grad_compute(x).to(gc.dtype), pb, pe)
    dw = _GRAD_FNS[nsp][1](xp, w_shape, gc, stride=s, padding=0, dilation=d,
                           groups=op.groups)
    return [dw.to(g.dtype)]


@lowering("ConvBiasGrad")
def conv_bias_grad(op, inputs, static, device):
    g = inputs[0]
    return [_grad_compute(g).sum(dim=(0,) + tuple(range(2, g.ndim)))
            .to(g.dtype)]


@lowering("ConvTranspose")
def conv_transpose(op, inputs, static, device):
    x, w = inputs[0], inputs[1]
    bias = inputs[2] if len(inputs) > 2 else None
    nsp = x.ndim - 2
    if nsp not in _CONV_FNS:
        raise NotImplementedError(f"ConvTranspose over {nsp} spatial axes")
    out_shape = op._out_shape(tuple(x.shape), tuple(w.shape))
    pads = list(op.pads or [0] * (2 * nsp))
    xc, wc = _compute_pair(x, w)
    # the whole transposed convolution, then ONNX's window of it: pads
    # crop its begin, the output size (output_padding) its end, zeros
    # past its last row
    full = _CONV_FNS[nsp][1](
        xc, wc, None, stride=tuple(op.strides or [1] * nsp),
        dilation=tuple(op.dilations or [1] * nsp), groups=op.groups)
    out = _pad_spatial(
        full, [-p for p in pads[:nsp]],
        [out_shape[2 + i] + pads[i] - full.shape[2 + i] for i in range(nsp)])
    return [_add_bias(out.to(x.dtype), bias)]


def _lowest(dtype: torch.dtype) -> float:
    return (-float("inf") if dtype.is_floating_point
            else torch.iinfo(dtype).min)


@lowering("Pool")
def pool(op, inputs, static, device):
    x = inputs[0]
    nsp = x.ndim - 2
    k, s, d, pb, pe, pe_ext, osp = op._geometry(tuple(x.shape))
    if op.mode == "max":
        xp = _pad_spatial(x, pb, pe_ext, _lowest(x.dtype))
        out = None
        for kpos in itertools.product(*[range(ki) for ki in k]):
            win = _window(xp, kpos, d, s, osp)
            out = win.clone() if out is None else torch.maximum(out, win)
        if op.n_out < 2:
            return [out]
        return [out, _max_indices(op, x, k, s, d, pb, pe_ext, osp)]
    acc = x if x.dtype == torch.float64 else x.float()
    xp = _pad_spatial(acc, pb, pe_ext)
    total = None
    for kpos in itertools.product(*[range(ki) for ki in k]):
        win = _window(xp, kpos, d, s, osp)
        total = win.clone() if total is None else total + win
    den = torch.from_numpy(np.ascontiguousarray(
        op._denom(tuple(x.shape), np))).to(device=x.device, dtype=acc.dtype)
    return [(total / den).to(x.dtype)]


def _max_indices(op, x, k, s, d, pb, pe_ext, osp) -> torch.Tensor:
    """MaxPool's Indices: the flat position of each window's first
    maximum in the input (row-major; storage_order 1 flattens a 2-D
    input's spatial axes column-major), padding never chosen."""
    nsp = x.ndim - 2
    N, C = x.shape[:2]
    sp = x.shape[2:]
    spn = int(np.prod(sp))
    if op.storage_order == 1 and nsp == 2:
        flat = (torch.arange(sp[1], device=x.device)[None, :] * sp[0]
                + torch.arange(sp[0], device=x.device)[:, None])
    else:
        flat = torch.arange(spn, device=x.device).reshape(sp)
    base = torch.arange(N * C, device=x.device).reshape(
        N, C, *([1] * nsp)) * spn
    idx = _pad_spatial((base + flat).double(), pb, pe_ext, -1.0).long()
    xp = _pad_spatial(x, pb, pe_ext, _lowest(x.dtype))
    best = best_i = None
    for kpos in itertools.product(*[range(ki) for ki in k]):
        win, wi = _window(xp, kpos, d, s, osp), _window(idx, kpos, d, s, osp)
        if best is None:
            best, best_i = win.clone(), wi.clone()
            continue
        take = (wi >= 0) & ((best_i < 0) | (win > best))
        best = torch.where(take, win, best)
        best_i = torch.where(take, wi, best_i)
    return best_i


@lowering("Resize")
def resize(op, inputs, static, device):
    x = inputs[0]

    def host(i):
        if len(inputs) <= i or inputs[i] is None:
            return None
        return need_static(static, i, "Resize")

    roi = host(1) if op.coord_mode == "tf_crop_and_resize" else None
    scales, sizes = host(2), host(3)
    _, plans = op._plan(tuple(x.shape), scales, sizes, roi)
    out = x
    for a, (idx, w, extrap) in plans.items():
        ti = torch.from_numpy(np.ascontiguousarray(idx.reshape(-1))).to(
            x.device)
        g = out.index_select(a, ti)
        if op.mode == "nearest":
            out = g        # one tap of weight 1: the gather itself
        else:
            acc = torch.float64 if x.dtype == torch.float64 else torch.float32
            g = g.reshape(out.shape[:a] + idx.shape + out.shape[a + 1:])
            wv = torch.from_numpy(np.ascontiguousarray(
                w.reshape((1,) * a + w.shape + (1,) * (out.ndim - a - 1))
            )).to(device=x.device, dtype=acc)
            out = (g.to(acc) * wv).sum(dim=a + 1)
        if extrap is not None and extrap.any():
            eb = torch.from_numpy(extrap.reshape(
                (1,) * a + extrap.shape + (1,) * (out.ndim - a - 1))).to(
                x.device)
            out = torch.where(eb, torch.tensor(op.extrapolation_value,
                                               dtype=out.dtype,
                                               device=x.device), out)
    return [out.to(x.dtype)]
