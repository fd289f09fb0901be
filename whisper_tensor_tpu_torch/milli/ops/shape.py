"""Shape, Reshape, Transpose, Squeeze, Unsqueeze and Split: the milli
op classes and their PyTorch lowerings.

The classes are the port's copy of whisper_tensor_tpu/milli/ops/
shape.py (numpy `eval` and shape inference; no `to_jax`). Shape
arguments (Reshape's target, Squeeze/Unsqueeze axes, Split sizes) must
be static: the executor folds them on the host. The lowerings reuse the
classes' own shape arithmetic (`_target`, `_perm`, `_axes`, `_expand`,
`_sizes`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ...dtype import DType
from ...scalar_info import ScalarInfo
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering


@dataclass
class Shape(MilliOp):
    """Tensor -> 1-D i64 shape. start/end slice per ONNX Shape-15."""

    start: int = 0
    end: Optional[int] = None
    KIND = "Shape"

    def _slice(self, rank: int):
        s = self.start if self.start >= 0 else self.start + rank
        e = self.end if self.end is not None else rank
        if e < 0:
            e += rank
        return max(0, min(s, rank)), max(0, min(e, rank))

    def eval(self, inputs):
        sh = inputs[0].shape
        s, e = self._slice(len(sh))
        return [np.asarray(sh[s:e], dtype=np.int64)]

    def infer(self, infos):
        i = infos[0]
        dims = i.dims()
        if dims is not None:
            s, e = self._slice(len(dims))
            sub = dims[s:e]
            if all(d.is_known for d in sub):
                return [TensorInfo.numeric(np.asarray([d.value() for d in sub], dtype=np.int64))]
            return [TensorInfo.shaped(DType.I64, [len(sub)])]
        if i.rank is not None:
            s, e = self._slice(i.rank)
            return [TensorInfo.shaped(DType.I64, [e - s])]
        return [TensorInfo.ranked(DType.I64, 1)]


@dataclass
class Reshape(MilliOp):
    """data, shape(i64) -> reshaped. ONNX semantics: 0 copies dim
    (unless allowzero), -1 infers."""

    allowzero: bool = False
    KIND = "Reshape"

    def _target(self, in_shape, spec) -> tuple:
        spec = [int(x) for x in spec]
        out = []
        for i, d in enumerate(spec):
            if d == 0 and not self.allowzero:
                out.append(in_shape[i])
            else:
                out.append(d)
        if -1 in out:
            n = 1
            for d in in_shape:
                n *= d
            known = 1
            for d in out:
                if d != -1:
                    known *= d
            out[out.index(-1)] = n // known if known else 0
        return tuple(out)

    def eval(self, inputs):
        data, spec = inputs
        return [data.reshape(self._target(data.shape, spec.reshape(-1)))]

    def infer(self, infos):
        data, spec = infos
        if spec.level is Level.NUMERIC:
            sv = spec.value.reshape(-1)
            cs = data.concrete_shape()
            if data.level is Level.NUMERIC:
                return [TensorInfo.numeric(self.eval([data.value, spec.value])[0])]
            if cs is not None:
                return [TensorInfo.shaped(data.dtype, self._target(cs, sv))]
            # partially static: fully-positive specs give the shape directly
            iv = [int(x) for x in sv]
            if all(d > 0 for d in iv):
                return [TensorInfo.shaped(data.dtype, iv)]
            dims = data.dims()
            if dims is not None and all(d != -1 for d in iv):
                out = [dims[i] if (d == 0 and not self.allowzero) else ScalarInfo.of(d)
                       for i, d in enumerate(iv)]
                return [TensorInfo.shaped(data.dtype, out)]
            return [TensorInfo.ranked(data.dtype, len(iv))]
        sd = spec.dims()
        if sd is not None and sd[0].is_known:
            return [TensorInfo.ranked(data.dtype, int(sd[0].value()))]
        return [TensorInfo.minimal(data.dtype)]


@dataclass
class Transpose(MilliOp):
    perm: Optional[List[int]] = None  # None = reverse axes
    swap_last2: bool = False          # transpose last two dims (matmul bwd)
    KIND = "Transpose"

    def _perm(self, rank: int) -> List[int]:
        if self.swap_last2:
            p = list(range(rank))
            if rank >= 2:
                p[-1], p[-2] = p[-2], p[-1]
            return p
        return list(self.perm) if self.perm is not None else list(reversed(range(rank)))

    def eval(self, inputs):
        x = inputs[0]
        return [np.transpose(x, self._perm(x.ndim))]

    def infer(self, infos):
        i = infos[0]
        if i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        dims = i.dims()
        if dims is not None:
            p = self._perm(len(dims))
            return [TensorInfo.shaped(i.dtype, [dims[j] for j in p])]
        if i.rank is not None:
            return [TensorInfo.ranked(i.dtype, i.rank)]
        return [i]


@dataclass
class Squeeze(MilliOp):
    axes: Optional[List[int]] = None  # None = squeeze all size-1 dims
    KIND = "Squeeze"

    def _axes(self, shape, axes_arr=None) -> List[int]:
        if axes_arr is not None:
            return sorted(int(a) % len(shape) for a in np.asarray(axes_arr).reshape(-1))
        if self.axes is None:
            return [i for i, d in enumerate(shape) if d == 1]
        return sorted(a % len(shape) for a in self.axes)

    def eval(self, inputs):
        x = inputs[0]
        axes_arr = inputs[1] if len(inputs) > 1 and inputs[1] is not None else None
        return [np.squeeze(x, axis=tuple(self._axes(x.shape, axes_arr)))]

    def infer(self, infos):
        i = infos[0]
        axes_info = infos[1] if len(infos) > 1 else None
        axes_arr = (axes_info.value if axes_info is not None
                    and axes_info.level is Level.NUMERIC else None)
        if len(infos) > 1 and axes_arr is None:
            return [TensorInfo.minimal(i.dtype)]
        if i.level is Level.NUMERIC:
            vals = [i.value] + ([axes_arr] if axes_arr is not None else [])
            return [TensorInfo.numeric(self.eval(vals)[0])]
        axes = ([int(a) for a in np.asarray(axes_arr).reshape(-1)]
                if axes_arr is not None else self.axes)
        dims = i.dims()
        if dims is not None:
            if axes is None:
                if not all(d.is_known for d in dims):
                    return [TensorInfo.minimal(i.dtype)]
                ax = [j for j, d in enumerate(dims) if d.value() == 1]
            else:
                ax = [a % len(dims) for a in axes]
            return [TensorInfo.shaped(i.dtype, [d for j, d in enumerate(dims) if j not in ax])]
        if i.rank is not None and axes is not None:
            return [TensorInfo.ranked(i.dtype, i.rank - len(axes))]
        return [TensorInfo.minimal(i.dtype)]


@dataclass
class Unsqueeze(MilliOp):
    axes: List[int] = field(default_factory=list)
    KIND = "Unsqueeze"

    def _expand(self, shape, axes_arr=None) -> tuple:
        axes = ([int(a) for a in np.asarray(axes_arr).reshape(-1)]
                if axes_arr is not None else self.axes)
        out_rank = len(shape) + len(axes)
        ax = sorted(a % out_rank for a in axes)
        out = []
        src = 0
        for i in range(out_rank):
            if i in ax:
                out.append(1)
            else:
                out.append(shape[src])
                src += 1
        return tuple(out)

    def eval(self, inputs):
        x = inputs[0]
        axes_arr = inputs[1] if len(inputs) > 1 and inputs[1] is not None else None
        return [x.reshape(self._expand(x.shape, axes_arr))]

    def infer(self, infos):
        i = infos[0]
        axes_info = infos[1] if len(infos) > 1 else None
        axes_arr = (axes_info.value if axes_info is not None
                    and axes_info.level is Level.NUMERIC else None)
        if len(infos) > 1 and axes_arr is None:
            return [TensorInfo.minimal(i.dtype)]
        axes = ([int(a) for a in np.asarray(axes_arr).reshape(-1)]
                if axes_arr is not None else list(self.axes))
        if i.level is Level.NUMERIC:
            vals = [i.value] + ([axes_arr] if axes_arr is not None else [])
            return [TensorInfo.numeric(self.eval(vals)[0])]
        dims = i.dims()
        if dims is not None:
            out_rank = len(dims) + len(axes)
            ax = sorted(a % out_rank for a in axes)
            out, src = [], 0
            for j in range(out_rank):
                if j in ax:
                    out.append(ScalarInfo.of(1))
                else:
                    out.append(dims[src])
                    src += 1
            return [TensorInfo.shaped(i.dtype, out)]
        if i.rank is not None:
            return [TensorInfo.ranked(i.dtype, i.rank + len(axes))]
        return [TensorInfo.minimal(i.dtype)]


@dataclass
class Split(MilliOp):
    """Static split: sizes resolved at lowering time."""

    axis: int = 0
    sizes: List[int] = field(default_factory=list)
    KIND = "Split"

    num_outputs: int = 0

    @property
    def N_OUTPUTS(self):  # type: ignore[override]
        return self.num_outputs or len(self.sizes)

    def _sizes(self, x_shape, sizes_arr=None) -> List[int]:
        if sizes_arr is not None:
            return [int(v) for v in np.asarray(sizes_arr).reshape(-1)]
        if self.sizes:
            return list(self.sizes)
        # equal split into num_outputs parts (last may be smaller)
        d = x_shape[self.axis % len(x_shape)]
        n = self.num_outputs
        chunk = -(-d // n)
        out = [chunk] * (d // chunk)
        if sum(out) < d:
            out.append(d - sum(out))
        return out

    def eval(self, inputs):
        x = inputs[0]
        sizes_arr = inputs[1] if len(inputs) > 1 and inputs[1] is not None else None
        splits = np.cumsum(self._sizes(x.shape, sizes_arr))[:-1]
        return list(np.split(x, splits, axis=self.axis))

    def infer(self, infos):
        i = infos[0]
        n_out = self.N_OUTPUTS
        sizes_info = infos[1] if len(infos) > 1 else None
        sizes_arr = (sizes_info.value if sizes_info is not None
                     and sizes_info.level is Level.NUMERIC else None)
        if len(infos) > 1 and sizes_arr is None:
            return [TensorInfo.minimal(i.dtype) for _ in range(n_out)]
        if i.level is Level.NUMERIC:
            vals = [i.value] + ([sizes_arr] if sizes_arr is not None else [])
            return [TensorInfo.numeric(v) for v in self.eval(vals)]
        cs = i.concrete_shape()
        if cs is not None:
            sizes = self._sizes(cs, sizes_arr)
            ax = self.axis % len(cs)
            outs = []
            for s in sizes:
                d = list(cs)
                d[ax] = s
                outs.append(TensorInfo.shaped(i.dtype, d))
            return outs
        return [TensorInfo.minimal(i.dtype) for _ in range(n_out)]


# -- lowerings ----------------------------------------------------------


def _need_static(static, idx: int, what: str) -> np.ndarray:
    if static is None or static[idx] is None:
        raise NotImplementedError(
            f"{what}: input {idx} must be static (host-folded)")
    return np.asarray(static[idx])


@lowering("Shape")
def shape(op, inputs, static, device):
    sh = tuple(inputs[0].shape)
    s, e = op._slice(len(sh))
    return [torch.tensor(sh[s:e], dtype=torch.int64, device=device)]


@lowering("Reshape")
def reshape(op, inputs, static, device):
    spec = _need_static(static, 1, "Reshape").reshape(-1)
    x = inputs[0]
    return [x.reshape(op._target(tuple(x.shape), spec))]


@lowering("Transpose")
def transpose(op, inputs, static, device):
    x = inputs[0]
    return [x.permute(op._perm(x.ndim))]


@lowering("Squeeze")
def squeeze(op, inputs, static, device):
    x = inputs[0]
    axes_arr = _need_static(static, 1, "Squeeze") if len(inputs) > 1 else None
    axes = set(op._axes(tuple(x.shape), axes_arr))
    return [x.reshape([d for i, d in enumerate(x.shape) if i not in axes])]


@lowering("Unsqueeze")
def unsqueeze(op, inputs, static, device):
    x = inputs[0]
    axes_arr = (_need_static(static, 1, "Unsqueeze") if len(inputs) > 1
                else None)
    return [x.reshape(op._expand(tuple(x.shape), axes_arr))]


@lowering("Split")
def split(op, inputs, static, device):
    x = inputs[0]
    sizes_arr = _need_static(static, 1, "Split") if len(inputs) > 1 else None
    sizes = op._sizes(tuple(x.shape), sizes_arr)
    return list(torch.split(x, sizes, dim=op.axis))
