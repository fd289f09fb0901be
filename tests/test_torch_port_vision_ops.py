"""The eight vision ops of the PyTorch port against the JAX package, on
the CPU.

GridSample, RoiAlign, AffineGrid, Col2Im, CenterCropPad,
NonMaxSuppression, DeformConv and ImageDecoder, each as one ONNX node
on numpy-seeded inputs beyond the conformance corpus's, through the
port's lowering (`Model.eval(..., device="cpu")`: milli/ops/vision.py)
and the JAX package's `Model.eval(mode="xla")`, whose lowering is XLA
for the first five and its numpy oracle for the other three (it keeps
them oracle-only). Floats within 1e-5 of the output's scale (f32; the
coordinate math is the same function in both), bf16 within one bf16
ulp of it (2^-7), integer outputs (NonMaxSuppression's indices,
ImageDecoder's pixels) exact. The port's own numpy oracle is held to
the reference's byte for byte on the corpus
(tests/test_torch_conformance_ops.py).
"""

from __future__ import annotations

import io

import ml_dtypes
import numpy as np
import pytest

from whisper_tensor_tpu.model import Model as JaxModel
from whisper_tensor_tpu_torch.dtype import DType
from whisper_tensor_tpu_torch.importers.onnx_builder import OnnxBuilder
from whisper_tensor_tpu_torch.model import Model

BF16 = np.dtype(ml_dtypes.bfloat16)


def _node(op_type, feeds, consts, attrs, out_dtype=None):
    """One-node ONNX bytes: `feeds` become graph inputs, `consts`
    initializers (host-static shape arguments), in the op's input
    order (None: an absent optional input)."""
    b = OnnxBuilder(f"one_{op_type}", opset=22)
    names = []
    for n, v in list(feeds.items()) + list(consts.items()):
        if v is None:
            names.append("")
            continue
        v = np.asarray(v)
        if n in consts:
            b.initializer(n, v)
        else:
            b.input(n, DType.from_numpy(v.dtype), list(v.shape))
        names.append(n)
    order = [n for n in attrs.pop("_order")]
    b.node(op_type, [names[[*feeds, *consts].index(n)] for n in order],
           outputs=["y"], **attrs)
    b.output("y", out_dtype or DType.from_numpy(
        np.asarray(next(iter(feeds.values()))).dtype), [])
    return b.build()


def _both(data, feeds):
    got = Model.new_from_onnx(data).eval(dict(feeds), device="cpu")["y"]
    want = JaxModel.new_from_onnx(data).eval(dict(feeds), mode="xla")["y"]
    return np.asarray(got), np.asarray(want)


def _close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.astype(np.float64), want.astype(np.float64)
    scale = max(float(np.abs(w).max()), 1e-30)
    tol = 1e-5 if dtype == "f32" else 2.0 ** -7
    assert float(np.abs(g - w).max()) <= tol * scale


R = np.random.default_rng(17)


def _grid_sample_cases():
    out = []
    for mode in ("linear", "nearest", "cubic"):
        for pad in ("zeros", "border", "reflection"):
            for align in (0, 1):
                out.append((f"{mode}-{pad}-{align}", mode, pad, align, 2))
    out += [("linear-zeros-0-3d", "linear", "zeros", 0, 3),
            ("nearest-reflection-1-3d", "nearest", "reflection", 1, 3)]
    return out


GRID_CASES = [pytest.param(c, "f32", id=c[0] + "-f32")
              for c in _grid_sample_cases()] + [
    pytest.param(c, "bf16", id=c[0] + "-bf16")
    for c in _grid_sample_cases() if c[2] == "reflection" or c[4] == 3]


@pytest.mark.parametrize("case,dtype", GRID_CASES)
def test_grid_sample_matches_the_jax_lowering(case, dtype):
    _, mode, pad, align, k = case
    dt = np.float32 if dtype == "f32" else BF16
    spatial = (5, 6) if k == 2 else (3, 4, 5)
    x = R.standard_normal((2, 3) + spatial).astype(dt)
    # coordinates past [-1, 1] exercise the padding modes
    grid = R.uniform(-1.3, 1.3, (2,) + tuple(s + 1 for s in spatial)
                     + (k,)).astype(dt)
    data = _node("GridSample", {"x": x, "grid": grid}, {},
                 {"_order": ["x", "grid"], "mode": mode,
                  "padding_mode": pad, "align_corners": align})
    _close(*_both(data, {"x": x, "grid": grid}), dtype)


@pytest.mark.parametrize("mode,ratio,ctm", [
    ("avg", 2, "half_pixel"), ("max", 2, "output_half_pixel"),
    ("avg", 0, "half_pixel"), ("max", 0, "output_half_pixel")])
def test_roi_align_matches_the_jax_package(mode, ratio, ctm):
    """An adaptive ratio (0) reads the rois' largest bin on the host in
    the port; the JAX package runs that case on its oracle."""
    x = R.standard_normal((2, 3, 10, 12)).astype(np.float32)
    lo = R.uniform(0, 6, (5, 2))
    rois = np.concatenate([lo, lo + R.uniform(1, 5, (5, 2))],
                          axis=1).astype(np.float32)
    bi = np.asarray([0, 1, 1, 0, 1], np.int64)
    data = _node("RoiAlign", {"x": x, "rois": rois, "bi": bi}, {},
                 {"_order": ["x", "rois", "bi"], "mode": mode,
                  "output_height": 3, "output_width": 4,
                  "sampling_ratio": ratio, "spatial_scale": 0.75,
                  "coordinate_transformation_mode": ctm})
    _close(*_both(data, {"x": x, "rois": rois, "bi": bi}), "f32")


@pytest.mark.parametrize("size,align", [((2, 3, 5, 7), 0), ((2, 3, 5, 7), 1),
                                        ((1, 2, 3, 4, 5), 0),
                                        ((1, 2, 3, 4, 5), 1)])
def test_affine_grid_matches_the_jax_lowering(size, align):
    k = len(size) - 2
    theta = R.standard_normal((size[0], k, k + 1)).astype(np.float32)
    data = _node("AffineGrid", {"theta": theta},
                 {"size": np.asarray(size, np.int64)},
                 {"_order": ["theta", "size"], "align_corners": align})
    _close(*_both(data, {"theta": theta}), "f32")


@pytest.mark.parametrize("kw", [{}, {"strides": [2, 1], "pads": [1, 0, 1, 2],
                                     "dilations": [1, 2]}])
def test_col2im_matches_the_jax_lowering(kw):
    img, blk = np.asarray([7, 8], np.int64), np.asarray([2, 3], np.int64)
    st, pd, dl = kw.get("strides", [1, 1]), kw.get("pads", [0] * 4), \
        kw.get("dilations", [1, 1])
    L = 1
    for i in range(2):
        L *= (img[i] + pd[i] + pd[2 + i] - dl[i] * (blk[i] - 1) - 1) \
            // st[i] + 1
    x = R.standard_normal((2, 3 * 6, L)).astype(np.float32)
    data = _node("Col2Im", {"x": x}, {"img": img, "blk": blk},
                 {"_order": ["x", "img", "blk"], **kw})
    _close(*_both(data, {"x": x}), "f32")


@pytest.mark.parametrize("shape,axes", [([4, 9, 3], None), ([7, 2], [0, 1]),
                                        ([5], [-2])])
def test_center_crop_pad_matches_the_jax_lowering(shape, axes):
    x = R.standard_normal((6, 5, 3)).astype(np.float32)
    attrs = {"_order": ["x", "shape"]}
    if axes is not None:
        attrs["axes"] = axes
    data = _node("CenterCropPad", {"x": x},
                 {"shape": np.asarray(shape, np.int64)}, attrs)
    got, want = _both(data, {"x": x})
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("center,max_out,score_th", [
    (0, 3, None), (1, 0, 0.3), (0, 2, 0.6)])
def test_non_max_suppression_matches_the_jax_oracle(center, max_out,
                                                    score_th):
    """Two batches of 12 boxes in 3 classes, ties in the scores: the
    port's device pass gives the oracle's indices in its order."""
    xy = R.uniform(0, 10, (2, 12, 2))
    wh = R.uniform(1, 5, (2, 12, 2))
    boxes = (np.concatenate([xy, wh], -1) if center
             else np.concatenate([xy, xy + wh], -1)).astype(np.float32)
    scores = np.round(R.uniform(0, 1, (2, 3, 12)), 1).astype(np.float32)
    consts = {"mo": np.asarray([max_out], np.int64),
              "iou": np.asarray([0.4], np.float32),
              "st": (np.asarray([score_th], np.float32)
                     if score_th is not None else None)}
    data = _node("NonMaxSuppression", {"boxes": boxes, "scores": scores},
                 consts, {"_order": ["boxes", "scores", "mo", "iou", "st"]
                          if score_th is not None else
                          ["boxes", "scores", "mo", "iou"],
                          "center_point_box": center}, out_dtype=DType.I64)
    got, want = _both(data, {"boxes": boxes, "scores": scores})
    assert got.dtype == np.int64 and len(want) > 3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("group,og,mask,bias", [(1, 1, False, False),
                                                (2, 2, True, True)])
def test_deform_conv_matches_the_jax_oracle(group, og, mask, bias):
    x = R.standard_normal((2, 4, 6, 7)).astype(np.float32)
    w = R.standard_normal((4, 4 // group, 3, 2)).astype(np.float32)
    st, pd, dl = [1, 2], [1, 0, 1, 1], [2, 1]
    oh = (6 + 2 - 2 * 2 - 1) // 1 + 1
    ow = (7 + 1 - 1 * 1 - 1) // 2 + 1
    feeds = {"x": x, "w": w,
             "off": (1.5 * R.standard_normal((2, og * 3 * 2 * 2, oh, ow))
                     ).astype(np.float32)}
    order = ["x", "w", "off"]
    if bias or mask:
        feeds["b"] = R.standard_normal(4).astype(np.float32) if bias \
            else None
        order.append("b")
    if mask:
        feeds["m"] = R.uniform(0, 1, (2, og * 6, oh, ow)).astype(np.float32)
        order.append("m")
    data = _node("DeformConv", {k: v for k, v in feeds.items()}, {},
                 {"_order": order, "group": group, "offset_group": og,
                  "kernel_shape": [3, 2], "strides": st, "pads": pd,
                  "dilations": dl})
    got, want = _both(data, {k: v for k, v in feeds.items()
                             if v is not None})
    _close(got, want, "f32")


@pytest.mark.parametrize("fmt,pixel_format", [("PNG", "RGB"),
                                              ("BMP", "BGR"),
                                              ("PNG", "Grayscale")])
def test_image_decoder_matches_the_jax_oracle(fmt, pixel_format):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(R.integers(0, 255, (9, 13, 3)).astype(np.uint8)).save(
        buf, format=fmt)
    data_in = np.frombuffer(buf.getvalue(), np.uint8)
    data = _node("ImageDecoder", {"data": data_in}, {},
                 {"_order": ["data"], "pixel_format": pixel_format})
    got, want = _both(data, {"data": data_in})
    assert got.dtype == np.uint8 and got.shape[:2] == (9, 13)
    np.testing.assert_array_equal(got, want)
