"""Vision milli ops: GridSample, RoiAlign, AffineGrid, Col2Im,
CenterCropPad, NonMaxSuppression, DeformConv, ImageDecoder, and their
PyTorch lowerings.

The classes are the port's copy of whisper_tensor_tpu/milli/ops/vision.py
(numpy `eval` and shape inference; no `to_jax`). As there, GridSample's,
RoiAlign's and AffineGrid's coordinate math is one function shared by the
numpy oracle and the lowering through an `xp` namespace: numpy itself for
`eval`, `_TorchXP` (the same names over torch, on the inputs' device) for
the lowering. Col2Im and CenterCropPad take their shapes as host values.

The reference keeps NonMaxSuppression and DeformConv oracle-only (a
data-dependent output size, a per-element loop); PyTorch is eager, so
here they lower to device tensor ops in f64, the oracle's type:
NonMaxSuppression's greedy pass runs one device step a candidate box
with no host read until the kept count, and DeformConv samples every tap
at once and sums the taps with one einsum a group. ImageDecoder decodes
on the host with PIL, as the reference does, and uploads the pixels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ...dtype import DType
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering, need_static


class _NumpyXP:
    """numpy under the names the shared functions call."""

    float32 = np.float32
    int64 = np.int64
    abs, clip, floor, rint, where = np.abs, np.clip, np.floor, np.rint, \
        np.where
    maximum, minimum, zeros_like, ones_like = np.maximum, np.minimum, \
        np.zeros_like, np.ones_like
    take_along_axis, swapaxes = np.take_along_axis, np.swapaxes

    @staticmethod
    def cast(a, dt):
        return a.astype(dt)

    @staticmethod
    def mod(a, b):
        return a % b

    @staticmethod
    def arange(n, like):
        return np.arange(n, dtype=like.dtype)

    @staticmethod
    def host_max(a) -> float:
        return float(np.max(a))

    @staticmethod
    def amax(a, axis):
        return a.max(axis=axis)

    @staticmethod
    def any(a, axis):
        return a.any(axis=axis)

    @staticmethod
    def mean(a, axis):
        return a.mean(axis=axis)


class _TorchXP:
    """torch under numpy's names (the lowerings' `xp`); new tensors go to
    the device of the tensor they are made like."""

    float32 = torch.float32
    int64 = torch.int64
    abs = staticmethod(torch.abs)
    floor = staticmethod(torch.floor)
    rint = staticmethod(torch.round)       # half to even, as np.rint
    where = staticmethod(torch.where)
    zeros_like = staticmethod(torch.zeros_like)
    ones_like = staticmethod(torch.ones_like)
    swapaxes = staticmethod(torch.swapaxes)

    @staticmethod
    def clip(a, lo, hi):
        return torch.clamp(a, lo, hi)

    @staticmethod
    def maximum(a, b):
        return torch.clamp(a, min=b) if not torch.is_tensor(b) else \
            torch.maximum(a, b)

    @staticmethod
    def minimum(a, b):
        return torch.clamp(a, max=b) if not torch.is_tensor(b) else \
            torch.minimum(a, b)

    @staticmethod
    def take_along_axis(a, idx, axis):
        return torch.take_along_dim(a, idx, dim=axis)

    @staticmethod
    def cast(a, dt):
        return a.to({np.int64: torch.int64, np.float32: torch.float32}.get(
            dt, dt))

    @staticmethod
    def mod(a, b):
        # the shared code takes the modulus of |.| only, where fmod is
        # numpy's % and exact
        return torch.fmod(a, b)

    @staticmethod
    def arange(n, like):
        return torch.arange(n, dtype=like.dtype, device=like.device)

    @staticmethod
    def host_max(a) -> float:
        return float(a.max())

    @staticmethod
    def amax(a, axis):
        return a.amax(dim=axis)

    @staticmethod
    def any(a, axis):
        return a.any(dim=axis)

    @staticmethod
    def mean(a, axis):
        return a.mean(dim=axis)


# the classes themselves: their functions stay unbound
NP, TX = _NumpyXP, _TorchXP


# ---------------------------------------------------------------------------
# GridSample
# ---------------------------------------------------------------------------

def _gs_unnormalize(c, size, align):
    if align:
        return (c + 1.0) * 0.5 * (size - 1)
    return ((c + 1.0) * size - 1.0) * 0.5


def _gs_reflect(xp, f, lo, hi):
    """Reflect float coords into [lo, hi] (torch reflection semantics)."""
    rng = hi - lo
    if rng <= 0:
        return xp.zeros_like(f) + lo
    f = xp.mod(xp.abs(f - lo), 2.0 * rng)
    return xp.where(f > rng, 2.0 * rng - f, f) + lo


def _cubic_weights(xp, t, a=-0.75):
    """4 cubic-convolution tap weights for fractional offset t (0..1)."""
    def w1(x):  # |x| <= 1
        return (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0

    def w2(x):  # 1 < |x| < 2
        return a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a

    return [w2(t + 1.0), w1(t), w1(1.0 - t), w2(2.0 - t)]


def _grid_sample(xp, x, grid, mode, pad, align):
    """x (N,C,*S), grid (N,*So,k) with grid[...,0]=innermost (W) coord.
    Returns (N,C,*So). Shared by the numpy oracle and the lowering."""
    k = grid.shape[-1]
    spatial = x.shape[2:]
    assert len(spatial) == k
    N, C = x.shape[0], x.shape[1]
    so = grid.shape[1:-1]
    P = 1
    for s in spatial:
        P *= int(s)
    xf = x.reshape(N, C, P)
    gf = xp.cast(grid.reshape(N, -1, k), xp.float32)

    # per-axis float coords, axis order = spatial order (outermost first)
    coords = []
    for ax in range(k):
        size = spatial[ax]
        c = gf[..., k - 1 - ax]  # grid last-dim is (x, y, z) = reversed
        f = _gs_unnormalize(c, float(size), align)
        if pad == "reflection":
            if align:
                f = _gs_reflect(xp, f, 0.0, float(size - 1))
            else:
                f = _gs_reflect(xp, f, -0.5, float(size) - 0.5)
            f = xp.clip(f, 0.0, float(size - 1))
        elif pad == "border":
            f = xp.clip(f, 0.0, float(size - 1))
        coords.append(f)

    def gather(idxs, weight):
        """idxs: per-axis int coords (N,Q); weight (N,Q) or scalar."""
        flat = idxs[0]
        for ax in range(1, k):
            flat = flat * spatial[ax] + idxs[ax]
        out = xp.take_along_axis(xf, xp.cast(flat[:, None, :], xp.int64),
                                 axis=2)
        return out * weight[:, None, :]

    def inb(i, ax):
        return (i >= 0) & (i <= spatial[ax] - 1)

    if mode == "nearest":
        idxs, ok = [], None
        for ax in range(k):
            i = xp.rint(coords[ax])
            m = inb(i, ax)
            ok = m if ok is None else (ok & m)
            idxs.append(xp.cast(xp.clip(i, 0, spatial[ax] - 1), xp.int64))
        w = xp.cast(ok, xf.dtype) if pad == "zeros" else \
            xp.cast(xp.ones_like(coords[0]), xf.dtype)
        out = gather(idxs, w)
    elif mode in ("linear", "bilinear"):
        lo, fr = [], []
        for ax in range(k):
            f0 = xp.floor(coords[ax])
            lo.append(f0)
            fr.append(coords[ax] - f0)
        out = None
        for corner in range(1 << k):
            idxs, w, ok = [], None, None
            for ax in range(k):
                hi_side = (corner >> ax) & 1
                i = lo[ax] + hi_side
                wa = fr[ax] if hi_side else (1.0 - fr[ax])
                w = wa if w is None else w * wa
                m = inb(i, ax)
                ok = m if ok is None else (ok & m)
                idxs.append(xp.cast(xp.clip(i, 0, spatial[ax] - 1),
                                    xp.int64))
            if pad == "zeros":
                w = w * xp.cast(ok, w.dtype)
            term = gather(idxs, xp.cast(w, xf.dtype))
            out = term if out is None else out + term
    elif mode in ("cubic", "bicubic"):
        if k != 2:
            raise NotImplementedError("GridSample cubic: 2-D only")
        lo, ws = [], []
        for ax in range(k):
            f0 = xp.floor(coords[ax])
            lo.append(f0)
            ws.append(_cubic_weights(xp, coords[ax] - f0))
        out = None
        for ty in range(4):
            for tx in range(4):
                iy = lo[0] + (ty - 1)
                ix = lo[1] + (tx - 1)
                w = ws[0][ty] * ws[1][tx]
                if pad == "zeros":
                    w = w * xp.cast(inb(iy, 0) & inb(ix, 1), w.dtype)
                idxs = [xp.cast(xp.clip(iy, 0, spatial[0] - 1), xp.int64),
                        xp.cast(xp.clip(ix, 0, spatial[1] - 1), xp.int64)]
                term = gather(idxs, xp.cast(w, xf.dtype))
                out = term if out is None else out + term
    else:
        raise NotImplementedError(f"GridSample mode {mode}")
    return out.reshape((N, C) + tuple(so))


@dataclass
class GridSampleMilli(MilliOp):
    """ONNX GridSample (4-D and 5-D, linear/nearest/cubic,
    zeros/border/reflection padding, align_corners)."""

    mode: str = "linear"
    padding_mode: str = "zeros"
    align_corners: bool = False
    KIND = "GridSample"

    def eval(self, inputs):
        x, grid = inputs[0], inputs[1]
        out = _grid_sample(NP, x.astype(np.float32),
                           grid.astype(np.float32), self.mode,
                           self.padding_mode, self.align_corners)
        return [out.astype(x.dtype)]

    def infer(self, infos):
        x, g = infos[0], infos[1]
        if all(i is not None and i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        dx, dg = x.dims(), g.dims()
        if dx is not None and dg is not None:
            return [TensorInfo.shaped(x.dtype,
                                      [dx[0], dx[1]] + list(dg[1:-1]))]
        if x.rank is not None:
            return [TensorInfo.ranked(x.dtype, x.rank)]
        return [TensorInfo.minimal(x.dtype)]


@lowering("GridSample")
def _lower_grid_sample(op, inputs, static, device):
    x, grid = inputs[0], inputs[1]
    out = _grid_sample(TX, x.float(), grid.float(), op.mode,
                       op.padding_mode, op.align_corners)
    return [out.to(x.dtype)]


# ---------------------------------------------------------------------------
# RoiAlign
# ---------------------------------------------------------------------------

def _roi_align(xp, x, rois, batch_idx, out_h, out_w, mode, ratio, scale,
               half_pixel):
    N, C, H, W = x.shape
    R = rois.shape[0]
    off = 0.5 if half_pixel else 0.0
    x1 = rois[:, 0] * scale - off
    y1 = rois[:, 1] * scale - off
    x2 = rois[:, 2] * scale - off
    y2 = rois[:, 3] * scale - off
    rw = x2 - x1
    rh = y2 - y1
    if not half_pixel:  # output_half_pixel mode keeps the legacy min-1
        rw = xp.maximum(rw, 1.0)
        rh = xp.maximum(rh, 1.0)
    bin_h = rh / out_h
    bin_w = rw / out_w
    if ratio > 0:
        sh = sw = ratio
    else:
        # adaptive: the ceiling of the largest bin over the rois (one
        # count for all rois, as the reference's oracle takes it)
        sh = int(np.ceil(xp.host_max(rh / out_h))) or 1
        sw = int(np.ceil(xp.host_max(rw / out_w))) or 1
    oy = xp.arange(out_h, x1)
    ox = xp.arange(out_w, x1)
    iy = xp.arange(sh, x1)
    ix = xp.arange(sw, x1)
    # sample coords: (R, out, s)
    ys = (y1[:, None, None] + oy[None, :, None] * bin_h[:, None, None]
          + (iy[None, None, :] + 0.5) * bin_h[:, None, None] / sh)
    xs = (x1[:, None, None] + ox[None, :, None] * bin_w[:, None, None]
          + (ix[None, None, :] + 0.5) * bin_w[:, None, None] / sw)
    y_ok = (ys >= -1.0) & (ys <= H)
    x_ok = (xs >= -1.0) & (xs <= W)
    yc = xp.clip(ys, 0.0, H - 1)
    xc = xp.clip(xs, 0.0, W - 1)
    y0 = xp.floor(yc)
    x0 = xp.floor(xc)
    wy1 = yc - y0
    wx1 = xc - x0
    y0i = xp.cast(y0, xp.int64)
    x0i = xp.cast(x0, xp.int64)
    y1i = xp.minimum(y0i + 1, H - 1)
    x1i = xp.minimum(x0i + 1, W - 1)
    xb = x[xp.cast(batch_idx, xp.int64)]         # (R, C, H, W)
    xb = xb.reshape(R, C, H * W)

    def pick(yi, xi):
        # yi (R,oh,sh), xi (R,ow,sw) -> (R, C, oh, ow, sh, sw)
        flat = (yi[:, :, :, None, None] * W
                + xi[:, None, None, :, :])       # (R, oh, sh, ow, sw)
        flat = flat.reshape(R, -1)
        v = xp.take_along_axis(xb, flat[:, None, :], axis=2)
        v = v.reshape(R, C, out_h, sh, out_w, sw)
        return xp.swapaxes(v, 3, 4)              # (R,C,oh,ow,sh,sw)

    w00 = ((1 - wy1)[:, :, :, None, None]
           * (1 - wx1)[:, None, None, :, :]).reshape(R, -1)
    w01 = ((1 - wy1)[:, :, :, None, None]
           * wx1[:, None, None, :, :]).reshape(R, -1)
    w10 = (wy1[:, :, :, None, None]
           * (1 - wx1)[:, None, None, :, :]).reshape(R, -1)
    w11 = (wy1[:, :, :, None, None]
           * wx1[:, None, None, :, :]).reshape(R, -1)

    def shape_w(w):
        return xp.swapaxes(w.reshape(R, 1, out_h, sh, out_w, sw), 3, 4)

    val = (pick(y0i, x0i) * shape_w(w00) + pick(y0i, x1i) * shape_w(w01)
           + pick(y1i, x0i) * shape_w(w10) + pick(y1i, x1i) * shape_w(w11))
    ok = (y_ok[:, :, :, None, None] & x_ok[:, None, None, :, :])
    ok = xp.swapaxes(ok.reshape(R, 1, out_h, sh, out_w, sw), 3, 4)
    val = val * xp.cast(ok, val.dtype)
    if mode == "max":
        big_neg = xp.where(ok, val, xp.zeros_like(val) - 1e30)
        out = xp.amax(big_neg.reshape(R, C, out_h, out_w, -1), -1)
        # all-masked bins produce 0 (matches the reference impl)
        any_ok = xp.any(ok.reshape(R, 1, out_h, out_w, -1), -1)
        out = xp.where(any_ok, out, xp.zeros_like(out))
    else:
        out = xp.mean(val.reshape(R, C, out_h, out_w, -1), -1)
    return out


@dataclass
class RoiAlignMilli(MilliOp):
    mode: str = "avg"
    output_height: int = 1
    output_width: int = 1
    sampling_ratio: int = 0
    spatial_scale: float = 1.0
    half_pixel: bool = True  # coordinate_transformation_mode == half_pixel
    KIND = "RoiAlign"

    def eval(self, inputs):
        x, rois, bi = inputs[0], inputs[1], inputs[2]
        out = _roi_align(NP, x.astype(np.float32), rois.astype(np.float32),
                         bi, self.output_height, self.output_width,
                         self.mode, self.sampling_ratio, self.spatial_scale,
                         self.half_pixel)
        return [out.astype(x.dtype)]

    def infer(self, infos):
        x, rois = infos[0], infos[1]
        if all(i is not None and i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        dx, dr = x.dims(), rois.dims()
        if dx is not None and dr is not None:
            return [TensorInfo.shaped(x.dtype, [dr[0], dx[1],
                                                self.output_height,
                                                self.output_width])]
        return [TensorInfo.ranked(x.dtype, 4)]


@lowering("RoiAlign")
def _lower_roi_align(op, inputs, static, device):
    # an adaptive sampling_ratio (0) reads the rois' largest bin on the
    # host: the one data-dependent size of the op
    x, rois, bi = inputs[0], inputs[1], inputs[2]
    out = _roi_align(TX, x.float(), rois.float(), bi,
                     op.output_height, op.output_width, op.mode,
                     op.sampling_ratio, op.spatial_scale, op.half_pixel)
    return [out.to(x.dtype)]


# ---------------------------------------------------------------------------
# AffineGrid
# ---------------------------------------------------------------------------

def _affine_axis(size, align):
    if align:
        if size == 1:
            return np.zeros(1, np.float32)
        return np.linspace(-1.0, 1.0, size).astype(np.float32)
    step = 2.0 / size
    return (np.arange(size, dtype=np.float32) * step + step / 2.0 - 1.0)


def _affine_grid(theta, size, align, device=None):
    """theta (N,2,3)/(N,3,4) + static size -> sampling grid for
    GridSample (N,H,W,2) / (N,D,H,W,3); numpy theta for the oracle, a
    tensor (the homogeneous base built on the host) for the lowering."""
    size = [int(s) for s in np.asarray(size).reshape(-1)]
    spatial = size[2:]
    k = len(spatial)
    axes = [_affine_axis(s, align) for s in spatial]
    # homogeneous coords (P, k+1) in (x, y[, z]) order = reversed
    mesh = np.meshgrid(*axes, indexing="ij")
    cols = [m.reshape(-1) for m in reversed(mesh)]
    cols.append(np.ones_like(cols[0]))
    base = np.stack(cols, axis=-1)                    # (P, k+1)
    if device is None:
        out = np.einsum("nij,pj->npi", theta.astype(base.dtype), base)
    else:
        out = torch.einsum("nij,pj->npi", theta.float(),
                           torch.from_numpy(base).to(device))
    return out.reshape((theta.shape[0],) + tuple(spatial) + (k,))


@dataclass
class AffineGridMilli(MilliOp):
    """theta (N,2,3)/(N,3,4) + static size -> sampling grid for
    GridSample (N,H,W,2) / (N,D,H,W,3)."""

    align_corners: bool = False
    KIND = "AffineGrid"

    def eval(self, inputs):
        return [np.asarray(_affine_grid(inputs[0].astype(np.float32),
                                        inputs[1], self.align_corners),
                           dtype=inputs[0].dtype)]

    def infer(self, infos):
        t = infos[0]
        if all(i is not None and i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        return [TensorInfo.minimal(t.dtype)]


@lowering("AffineGrid")
def _lower_affine_grid(op, inputs, static, device):
    size = need_static(static, 1, "AffineGrid")
    theta = inputs[0]
    return [_affine_grid(theta, size, op.align_corners,
                         theta.device).to(theta.dtype)]


# ---------------------------------------------------------------------------
# Col2Im
# ---------------------------------------------------------------------------

@dataclass
class Col2ImMilli(MilliOp):
    """Rearrange column blocks back into an image (inverse Im2Col).
    image_shape/block_shape are static inputs; N-D spatial."""

    dilations: Optional[List[int]] = None
    pads: Optional[List[int]] = None
    strides: Optional[List[int]] = None
    KIND = "Col2Im"

    def _params(self, k):
        dil = self.dilations or [1] * k
        pads = self.pads or [0] * (2 * k)
        strides = self.strides or [1] * k
        return dil, pads, strides

    def _col2im(self, x, image_shape, block_shape):
        """numpy x for the oracle, a tensor for the lowering."""
        image_shape = [int(s) for s in np.asarray(image_shape).reshape(-1)]
        block = [int(s) for s in np.asarray(block_shape).reshape(-1)]
        k = len(image_shape)
        dil, pads, strides = self._params(k)
        N = x.shape[0]
        K = 1
        for b in block:
            K *= b
        C = x.shape[1] // K
        # block positions per axis
        npos = [(image_shape[i] + pads[i] + pads[k + i]
                 - dil[i] * (block[i] - 1) - 1) // strides[i] + 1
                for i in range(k)]
        xs = x.reshape((N, C) + tuple(block) + tuple(npos))
        padded = [image_shape[i] + pads[i] + pads[k + i] for i in range(k)]
        if isinstance(x, torch.Tensor):
            out = torch.zeros((N, C) + tuple(padded), dtype=xs.dtype,
                              device=xs.device)
        else:
            out = np.zeros((N, C) + tuple(padded), xs.dtype)
        for kidx in np.ndindex(*block):
            sl = (slice(None), slice(None)) + tuple(
                slice(kidx[i] * dil[i],
                      kidx[i] * dil[i] + npos[i] * strides[i], strides[i])
                for i in range(k))
            out[sl] += xs[(slice(None), slice(None)) + kidx]
        crop = (slice(None), slice(None)) + tuple(
            slice(pads[i], pads[i] + image_shape[i]) for i in range(k))
        return out[crop]

    def eval(self, inputs):
        return [self._col2im(inputs[0], inputs[1], inputs[2])]

    def infer(self, infos):
        x = infos[0]
        if all(i is not None and i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        return [TensorInfo.minimal(x.dtype)]


@lowering("Col2Im")
def _lower_col2im(op, inputs, static, device):
    img = need_static(static, 1, "Col2Im")
    blk = need_static(static, 2, "Col2Im")
    return [op._col2im(inputs[0], img, blk).contiguous()]


# ---------------------------------------------------------------------------
# CenterCropPad
# ---------------------------------------------------------------------------

@dataclass
class CenterCropPadMilli(MilliOp):
    """Center-crop or center-pad each selected axis to a target extent
    (ONNX-18 CenterCropPad; shape input must be static)."""

    axes: Optional[List[int]] = None
    KIND = "CenterCropPad"

    def _plan(self, shape, target):
        """Per axis (axis, crop start and length) or (axis, pad before
        and after)."""
        tgt = [int(s) for s in np.asarray(target).reshape(-1)]
        axes = self.axes
        if axes is None:
            axes = list(range(len(tgt)))
        ndim = len(shape)
        out = []
        for a, t in zip([a % ndim for a in axes], tgt):
            cur = shape[a]
            if cur > t:
                out.append((a, "crop", (cur - t) // 2, t))
            elif cur < t:
                before = (t - cur) // 2
                out.append((a, "pad", before, t - cur - before))
        return out

    def eval(self, inputs):
        x = inputs[0]
        for a, how, p, q in self._plan(list(x.shape), inputs[1]):
            if how == "crop":
                sl = [slice(None)] * x.ndim
                sl[a] = slice(p, p + q)
                x = x[tuple(sl)]
            else:
                pads = [(0, 0)] * x.ndim
                pads[a] = (p, q)
                x = np.pad(x, pads)
        return [x]

    def infer(self, infos):
        x = infos[0]
        if all(i is not None and i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        if x.rank is not None:
            return [TensorInfo.ranked(x.dtype, x.rank)]
        return [TensorInfo.minimal(x.dtype)]


@lowering("CenterCropPad")
def _lower_center_crop_pad(op, inputs, static, device):
    x = inputs[0]
    for a, how, p, q in op._plan(list(x.shape),
                                 need_static(static, 1, "CenterCropPad")):
        if how == "crop":
            x = x.narrow(a, p, q)
        else:
            shape = list(x.shape)
            shape[a] = p + q + x.shape[a]
            out = torch.zeros(shape, dtype=x.dtype, device=x.device)
            out.narrow(a, p, x.shape[a]).copy_(x)
            x = out
    return [x.contiguous()]


# ---------------------------------------------------------------------------
# NonMaxSuppression
# ---------------------------------------------------------------------------

def _nms_args(inputs, host):
    """(max_out, iou_threshold, score_threshold or None) from the
    optional inputs 2-4 (host values)."""
    def scalar(k):
        if len(inputs) > k and inputs[k] is not None:
            v = np.asarray(host(inputs[k]))
            if v.size:
                return v.reshape(-1)[0]
        return None

    mo, iou, st = scalar(2), scalar(3), scalar(4)
    return (int(mo) if mo is not None else 0,
            float(iou) if iou is not None else 0.0,
            float(st) if st is not None else None)


@dataclass
class NonMaxSuppressionMilli(MilliOp):
    center_point_box: bool = False
    KIND = "NonMaxSuppression"

    def eval(self, inputs):
        boxes, scores = inputs[0], inputs[1]
        max_out, iou_th, score_th = _nms_args(inputs, lambda v: v)

        def corners(b):
            if not self.center_point_box:
                y1, x1, y2, x2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
                return (np.minimum(y1, y2), np.minimum(x1, x2),
                        np.maximum(y1, y2), np.maximum(x1, x2))
            xc, yc, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
            return (yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2)

        sel = []
        for n in range(boxes.shape[0]):
            y1, x1, y2, x2 = corners(boxes[n].astype(np.float64))
            area = (y2 - y1) * (x2 - x1)
            for c in range(scores.shape[1]):
                s = scores[n, c].astype(np.float64)
                order = np.argsort(-s, kind="stable")
                if score_th is not None:
                    order = order[s[order] > score_th]
                kept = []
                for i in order:
                    ok = True
                    for j in kept:
                        yy1 = max(y1[i], y1[j])
                        xx1 = max(x1[i], x1[j])
                        yy2 = min(y2[i], y2[j])
                        xx2 = min(x2[i], x2[j])
                        inter = max(0.0, yy2 - yy1) * max(0.0, xx2 - xx1)
                        union = area[i] + area[j] - inter
                        if union > 0 and inter / union > iou_th:
                            ok = False
                            break
                    if ok:
                        kept.append(i)
                        if max_out and len(kept) >= max_out:
                            break
                sel.extend([n, c, int(i)] for i in kept)
        return [np.asarray(sel, dtype=np.int64).reshape(-1, 3)]

    def infer(self, infos):
        if all(i is None or i.level is Level.NUMERIC for i in infos):
            vals = [None if i is None else i.value for i in infos]
            if vals[0] is not None and vals[1] is not None:
                return [TensorInfo.numeric(self.eval(vals)[0])]
        return [TensorInfo(DType.I64, Level.RANKED, rank_=2)]


@lowering("NonMaxSuppression")
def _lower_nms(op, inputs, static, device):
    """The oracle's greedy pass on the device, in f64: boxes in score
    order (stable), each kept iff no kept box before it overlaps it past
    the threshold. A kept box's fate depends only on those before it, so
    the max_output_boxes_per_class cut keeps the first kept ones."""
    boxes, scores = inputs[0].double(), inputs[1].double()
    max_out, iou_th, score_th = _nms_args(
        inputs, lambda v: v.cpu().numpy() if torch.is_tensor(v) else v)
    if op.center_point_box:
        xc, yc, w, h = boxes.unbind(-1)
        y1, x1, y2, x2 = yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2
    else:
        a, b, c, d = boxes.unbind(-1)
        y1, x1 = torch.minimum(a, c), torch.minimum(b, d)
        y2, x2 = torch.maximum(a, c), torch.maximum(b, d)
    N, Cn, B = scores.shape
    # pairwise intersection over union: (N, B, B)
    inter = ((torch.minimum(y2[:, :, None], y2[:, None, :])
              - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp(min=0)
             * (torch.minimum(x2[:, :, None], x2[:, None, :])
                - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp(min=0))
    area = (y2 - y1) * (x2 - x1)
    union = area[:, :, None] + area[:, None, :] - inter
    over = (union > 0) & (inter / torch.where(union > 0, union,
                                              torch.ones_like(union)) > iou_th)
    # per (n, c): candidates in score order
    neg, order = torch.sort(-scores, dim=-1, stable=True)       # (N, C, B)
    live = (-neg > score_th) if score_th is not None else \
        torch.ones_like(neg, dtype=torch.bool)
    # over[n, order[i], order[j]] in score order: (N, C, B, B)
    ov = over[:, None].expand(N, Cn, B, B)
    ov = torch.take_along_dim(ov, order[..., :, None], dim=2)
    ov = torch.take_along_dim(ov, order[..., None, :], dim=3)
    kept = torch.zeros_like(live)
    for i in range(B):
        hit = (ov[..., i, :i] & kept[..., :i]).any(dim=-1)
        kept[..., i] = live[..., i] & ~hit
    if max_out:
        kept &= torch.cumsum(kept.long(), dim=-1) <= max_out
    n_idx, c_idx, rank = torch.nonzero(kept, as_tuple=True)  # row-major
    return [torch.stack([n_idx, c_idx, order[n_idx, c_idx, rank]],
                        dim=1).to(torch.int64)]


# ---------------------------------------------------------------------------
# DeformConv
# ---------------------------------------------------------------------------

@dataclass
class DeformConvMilli(MilliOp):
    dilations: Optional[List[int]] = None
    group: int = 1
    kernel_shape: Optional[List[int]] = None
    offset_group: int = 1
    pads: Optional[List[int]] = None
    strides: Optional[List[int]] = None
    KIND = "DeformConv"

    def _geometry(self, x_shape, w_shape):
        N, C, H, W = x_shape
        kh, kw = (self.kernel_shape or list(w_shape[2:]))
        dil = self.dilations or [1, 1]
        pads = self.pads or [0, 0, 0, 0]
        strides = self.strides or [1, 1]
        oh = (H + pads[0] + pads[2] - dil[0] * (kh - 1) - 1) // strides[0] + 1
        ow = (W + pads[1] + pads[3] - dil[1] * (kw - 1) - 1) // strides[1] + 1
        return kh, kw, dil, pads, strides, oh, ow

    def eval(self, inputs):
        x, w, off = (inputs[0].astype(np.float64),
                     inputs[1].astype(np.float64),
                     inputs[2].astype(np.float64))
        bias = (inputs[3].astype(np.float64) if len(inputs) > 3
                and inputs[3] is not None else None)
        mask = (inputs[4].astype(np.float64) if len(inputs) > 4
                and inputs[4] is not None else None)
        N, C, H, W = x.shape
        M = w.shape[0]
        kh, kw, dil, pads, strides, oh, ow = self._geometry(x.shape, w.shape)
        og = self.offset_group
        out = np.zeros((N, M, oh, ow))
        cg = C // self.group
        mg = M // self.group

        def sample(n, c, y, xq):
            if y <= -1 or y >= H or xq <= -1 or xq >= W:
                return 0.0
            y0, x0 = int(np.floor(y)), int(np.floor(xq))
            v = 0.0
            for dy in (0, 1):
                for dx in (0, 1):
                    yy, xx = y0 + dy, x0 + dx
                    if 0 <= yy < H and 0 <= xx < W:
                        wy = (y - y0) if dy else (1 - (y - y0))
                        wx = (xq - x0) if dx else (1 - (xq - x0))
                        v += wy * wx * x[n, c, yy, xx]
            return v

        offr = off.reshape(N, og, kh, kw, 2, oh, ow)
        if mask is not None:
            maskr = mask.reshape(N, og, kh, kw, oh, ow)
        for n in range(N):
            for m in range(M):
                g = m // mg
                for o_y in range(oh):
                    for o_x in range(ow):
                        acc = 0.0
                        for ci in range(cg):
                            c = g * cg + ci
                            geo = (c * og // C) if og > 1 else 0
                            for ky in range(kh):
                                for kx in range(kw):
                                    y = (o_y * strides[0] - pads[0]
                                         + ky * dil[0]
                                         + offr[n, geo, ky, kx, 0, o_y, o_x])
                                    xq = (o_x * strides[1] - pads[1]
                                          + kx * dil[1]
                                          + offr[n, geo, ky, kx, 1, o_y, o_x])
                                    v = sample(n, c, y, xq)
                                    if mask is not None:
                                        v *= maskr[n, geo, ky, kx, o_y, o_x]
                                    acc += v * w[m, ci, ky, kx]
                        out[n, m, o_y, o_x] = acc
                if bias is not None:
                    out[n, m] += bias[m]
        return [out.astype(inputs[0].dtype)]

    def infer(self, infos):
        x = infos[0]
        if all(i is None or (i is not None and i.level is Level.NUMERIC)
               for i in infos) and infos[0] is not None:
            vals = [None if i is None else i.value for i in infos]
            if all(v is not None for v in vals[:3]):
                return [TensorInfo.numeric(self.eval(vals)[0])]
        return [TensorInfo.ranked(x.dtype, 4)]


@lowering("DeformConv")
def _lower_deform_conv(op, inputs, static, device):
    """Every tap of every output position sampled at once (bilinear, 0
    outside, the oracle's rule), then one einsum a group; in f64."""
    x, w, off = (inputs[0].double(), inputs[1].double(),
                 inputs[2].double())
    bias = inputs[3] if len(inputs) > 3 else None
    mask = inputs[4] if len(inputs) > 4 else None
    N, C, H, W = x.shape
    M = w.shape[0]
    kh, kw, dil, pads, strides, oh, ow = op._geometry(x.shape, w.shape)
    og = op.offset_group
    dev = x.device
    offr = off.reshape(N, og, kh, kw, 2, oh, ow)
    ky = torch.arange(kh, device=dev, dtype=torch.float64)
    kx = torch.arange(kw, device=dev, dtype=torch.float64)
    oy = torch.arange(oh, device=dev, dtype=torch.float64)
    ox = torch.arange(ow, device=dev, dtype=torch.float64)
    # (N, og, kh, kw, oh, ow) sample positions
    y = ((oy * strides[0] - pads[0])[None, :, None]
         + (ky * dil[0])[:, None, None])[None, None, :, None] \
        + offr[:, :, :, :, 0]
    xq = ((ox * strides[1] - pads[1])[None, None, :]
          + (kx * dil[1])[:, None, None])[None, None, None] \
        + offr[:, :, :, :, 1]
    inside = (y > -1) & (y < H) & (xq > -1) & (xq < W)
    y0, x0 = torch.floor(y), torch.floor(xq)
    fy, fx = y - y0, xq - x0
    # each channel reads its offset group's positions
    geo = (torch.arange(C, device=dev) * og // C) if og > 1 else \
        torch.zeros(C, dtype=torch.int64, device=dev)
    xf = x.reshape(N, C, H * W)
    cols = torch.zeros(N, C, kh * kw * oh * ow, dtype=torch.float64,
                       device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            ok = inside & (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            wgt = (fy if dy else 1 - fy) * (fx if dx else 1 - fx) * ok
            flat = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
            flat = flat.reshape(N, og, -1)[:, geo]          # (N, C, P)
            cols += torch.gather(xf, 2, flat) * \
                wgt.reshape(N, og, -1)[:, geo]
    cols = cols.reshape(N, C, kh, kw, oh, ow)
    if mask is not None:
        maskr = mask.double().reshape(N, og, kh, kw, oh, ow)
        cols = cols * maskr[:, geo]
    cg, mg = C // op.group, M // op.group
    out = torch.cat([torch.einsum("ncyxhw,mcyx->nmhw",
                                  cols[:, g * cg:(g + 1) * cg],
                                  w[g * mg:(g + 1) * mg])
                     for g in range(op.group)], dim=1)
    if bias is not None:
        out = out + bias.double()[None, :, None, None]
    return [out.to(inputs[0].dtype)]


# ---------------------------------------------------------------------------
# ImageDecoder (the host's PIL, as the reference)
# ---------------------------------------------------------------------------

def _decode_image(data: np.ndarray, pixel_format: str) -> np.ndarray:
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(np.asarray(data, dtype=np.uint8).tobytes()))
    if pixel_format == "Grayscale":
        img = img.convert("L")
        arr = np.asarray(img, dtype=np.uint8)[..., None]
    else:
        img = img.convert("RGB")
        arr = np.asarray(img, dtype=np.uint8)
        if pixel_format == "BGR":
            arr = arr[..., ::-1]
    return np.ascontiguousarray(arr)


@dataclass
class ImageDecoderMilli(MilliOp):
    pixel_format: str = "RGB"
    KIND = "ImageDecoder"

    def eval(self, inputs):
        return [_decode_image(inputs[0], self.pixel_format)]

    def infer(self, infos):
        i = infos[0]
        if i is not None and i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        return [TensorInfo(DType.U8, Level.RANKED, rank_=3)]


@lowering("ImageDecoder")
def _lower_image_decoder(op, inputs, static, device):
    data = inputs[0].cpu().numpy()
    pixels = np.array(_decode_image(data, op.pixel_format))   # writable
    return [torch.from_numpy(pixels).to(inputs[0].device)]
