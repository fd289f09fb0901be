"""Vision symbolic ops: GridSample, RoiAlign, AffineGrid, Col2Im,
CenterCropPad, NonMaxSuppression, DeformConv, ImageDecoder.

Covers the official ONNX vision families the reference enumerates in
tests/onnx_testing.rs (gridsample/roialign/affine_grid/col2im/
center_crop_pad/nonmaxsuppression/deform_conv/image_decoder).

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/vision.py."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ...milli.ops.vision import (AffineGridMilli, CenterCropPadMilli,
                                 Col2ImMilli, DeformConvMilli,
                                 GridSampleMilli, ImageDecoderMilli,
                                 NonMaxSuppressionMilli, RoiAlignMilli)
from .base import Operation, register


@register("GridSample")
@dataclass
class GridSample(Operation):
    mode: str = "linear"
    padding_mode: str = "zeros"
    align_corners: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        mode = attrs.s("mode", "linear")
        # opset-16 spelling -> opset-20 canonical
        mode = {"bilinear": "linear", "bicubic": "cubic"}.get(mode, mode)
        return cls(mode, attrs.s("padding_mode", "zeros"),
                   bool(attrs.i("align_corners", 0)))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(GridSampleMilli(self.mode, self.padding_mode,
                                          self.align_corners),
                          inputs[0], inputs[1])]


@register("RoiAlign")
@dataclass
class RoiAlign(Operation):
    mode: str = "avg"
    output_height: int = 1
    output_width: int = 1
    sampling_ratio: int = 0
    spatial_scale: float = 1.0
    half_pixel: bool = True

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        ctm = attrs.s("coordinate_transformation_mode", "half_pixel")
        return cls(attrs.s("mode", "avg"), attrs.i("output_height", 1),
                   attrs.i("output_width", 1), attrs.i("sampling_ratio", 0),
                   attrs.f("spatial_scale", 1.0), ctm == "half_pixel")

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(RoiAlignMilli(
            self.mode, self.output_height, self.output_width,
            self.sampling_ratio, self.spatial_scale, self.half_pixel),
            inputs[0], inputs[1], inputs[2])]


@register("AffineGrid")
@dataclass
class AffineGrid(Operation):
    align_corners: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(bool(attrs.i("align_corners", 0)))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(AffineGridMilli(self.align_corners),
                          inputs[0], inputs[1])]


@register("Col2Im")
@dataclass
class Col2Im(Operation):
    dilations: Optional[List[int]] = None
    pads: Optional[List[int]] = None
    strides: Optional[List[int]] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.ints("dilations", None), attrs.ints("pads", None),
                   attrs.ints("strides", None))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(Col2ImMilli(self.dilations, self.pads,
                                      self.strides),
                          inputs[0], inputs[1], inputs[2])]


@register("CenterCropPad")
@dataclass
class CenterCropPad(Operation):
    axes: Optional[List[int]] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.ints("axes", None))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(CenterCropPadMilli(self.axes),
                          inputs[0], inputs[1])]


@register("NonMaxSuppression")
@dataclass
class NonMaxSuppression(Operation):
    center_point_box: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(bool(attrs.i("center_point_box", 0)))

    def lower(self, ctx, inputs, n_outputs):
        args = list(inputs)
        while args and args[-1] is None:
            args.pop()
        return [ctx.emit1(NonMaxSuppressionMilli(self.center_point_box),
                          *args)]


@register("DeformConv")
@dataclass
class DeformConv(Operation):
    dilations: Optional[List[int]] = None
    group: int = 1
    kernel_shape: Optional[List[int]] = None
    offset_group: int = 1
    pads: Optional[List[int]] = None
    strides: Optional[List[int]] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.ints("dilations", None), attrs.i("group", 1),
                   attrs.ints("kernel_shape", None),
                   attrs.i("offset_group", 1), attrs.ints("pads", None),
                   attrs.ints("strides", None))

    def lower(self, ctx, inputs, n_outputs):
        args = list(inputs)
        while args and args[-1] is None:
            args.pop()
        return [ctx.emit1(DeformConvMilli(
            self.dilations, self.group, self.kernel_shape,
            self.offset_group, self.pads, self.strides), *args)]


@register("ImageDecoder")
@dataclass
class ImageDecoder(Operation):
    pixel_format: str = "RGB"

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.s("pixel_format", "RGB"))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(ImageDecoderMilli(self.pixel_format), inputs[0])]
