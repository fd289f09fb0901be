"""Long-tail symbolic ops: LRN, Det, DynamicQuantizeLinear, Bernoulli,
spectral windows, Unique, Compress, string ops, ai.onnx.ml ops and
the ai.onnx.preview.training optimizers.

These close the remaining official-corpus op families the reference
enumerates (tests/onnx_testing.rs).

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/extra.py
without DFT, QLinearConv and ConvInteger, which wait for the signal and
convolution milli ops (symbolic_graph/ops/not_ported.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ...dtype import DType, ONNX_TO_DTYPE
from ...milli.ops.extra import (ArrayFeatureExtractorMilli, BernoulliMilli,
                                BinarizerMilli, CompressMilli, DetMilli,
                                DynamicQuantizeLinearMilli,
                                LabelEncoderMilli, LRNMilli,
                                RegexFullMatchMilli, StringConcatMilli,
                                StringNormalizerMilli, StringSplitMilli,
                                TrainingOptimizerMilli, TreeEnsembleMilli,
                                UniqueMilli, WindowMilli)
from .base import Operation, register


@register("LRN")
@dataclass
class LRN(Operation):
    alpha: float = 1e-4
    beta: float = 0.75
    bias: float = 1.0
    size: int = 1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("alpha", 1e-4), attrs.f("beta", 0.75),
                   attrs.f("bias", 1.0), attrs.i("size", 1))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(LRNMilli(self.alpha, self.beta, self.bias,
                                   self.size), inputs[0])]


@register("Det")
@dataclass
class Det(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(DetMilli(), inputs[0])]


@register("DynamicQuantizeLinear")
@dataclass
class DynamicQuantizeLinear(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return ctx.emit(DynamicQuantizeLinearMilli(), inputs[0],
                        n_outputs=3)[:n_outputs]


@register("Bernoulli")
@dataclass
class Bernoulli(Operation):
    dtype: Optional[DType] = None
    seed: Optional[float] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        dt = attrs.i("dtype", None)
        return cls(ONNX_TO_DTYPE[dt] if dt is not None else None,
                   attrs.f("seed", None))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(BernoulliMilli(self.dtype, self.seed),
                          inputs[0])]


def _window_cls(kind):
    @dataclass
    class _Window(Operation):
        periodic: bool = True
        dtype: DType = DType.F32

        @classmethod
        def from_onnx(cls, node, attrs, opset):
            dt = attrs.i("output_datatype", 1)
            return cls(bool(attrs.i("periodic", 1)), ONNX_TO_DTYPE[dt])

        def lower(self, ctx, inputs, n_outputs):
            return [ctx.emit1(WindowMilli(kind, self.periodic, self.dtype),
                              inputs[0])]

    _Window.__name__ = kind.capitalize() + "Window"
    return _Window


register("HannWindow")(_window_cls("hann"))
register("HammingWindow")(_window_cls("hamming"))
register("BlackmanWindow")(_window_cls("blackman"))


@register("Unique")
@dataclass
class Unique(Operation):
    axis: Optional[int] = None
    sorted: bool = True

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", None), bool(attrs.i("sorted", 1)))

    def lower(self, ctx, inputs, n_outputs):
        return ctx.emit(UniqueMilli(self.axis, self.sorted), inputs[0],
                        n_outputs=4)[:n_outputs]


@register("Compress")
@dataclass
class Compress(Operation):
    axis: Optional[int] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", None))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(CompressMilli(self.axis), inputs[0], inputs[1])]


@register("StringConcat")
@dataclass
class StringConcat(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(StringConcatMilli(), inputs[0], inputs[1])]


@register("StringSplit")
@dataclass
class StringSplit(Operation):
    delimiter: Optional[str] = None
    maxsplit: Optional[int] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.s("delimiter", None), attrs.i("maxsplit", None))

    def lower(self, ctx, inputs, n_outputs):
        return ctx.emit(StringSplitMilli(self.delimiter, self.maxsplit),
                        inputs[0], n_outputs=2)[:n_outputs]


@register("StringNormalizer")
@dataclass
class StringNormalizer(Operation):
    case_change_action: str = "NONE"
    is_case_sensitive: bool = False
    locale: Optional[str] = None
    stopwords: Optional[List[str]] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.s("case_change_action", "NONE"),
                   bool(attrs.i("is_case_sensitive", 0)),
                   attrs.s("locale", None),
                   attrs.strings("stopwords", None))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(StringNormalizerMilli(
            self.case_change_action, self.is_case_sensitive, self.locale,
            self.stopwords), inputs[0])]


@register("RegexFullMatch")
@dataclass
class RegexFullMatch(Operation):
    pattern: str = ""

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.s("pattern", ""))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(RegexFullMatchMilli(self.pattern), inputs[0])]


@register("LabelEncoder")
@dataclass
class LabelEncoder(Operation):
    keys: List = field(default_factory=list)
    values: List = field(default_factory=list)
    default: object = None
    value_is_string: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        kt = attrs.t("keys_tensor")
        keys = (attrs.strings("keys_strings", None)
                or attrs.ints("keys_int64s", None)
                or attrs.floats("keys_floats", None)
                or (list(np.asarray(kt).reshape(-1))
                    if kt is not None else None))
        vals_s = attrs.strings("values_strings", None)
        vals = (vals_s or attrs.ints("values_int64s", None)
                or attrs.floats("values_floats", None))
        vt = attrs.t("values_tensor")
        if vals is None and vt is not None:
            vt = np.asarray(vt)
            vals = list(vt.reshape(-1))
            if vt.dtype == np.dtype(object) or vt.dtype.kind in "US":
                vals_s = vals
        default = (attrs.s("default_string", None)
                   if vals_s is not None else None)
        if default is None:
            default = attrs.i("default_int64", None)
        if default is None:
            default = attrs.f("default_float", None)
        dt = attrs.t("default_tensor")
        if default is None and dt is not None:
            default = np.asarray(dt).reshape(-1)[0]
            if isinstance(default, bytes):
                default = default.decode()
        # normalize key types (bytes from tensor attrs -> str)
        if keys:
            keys = [k.decode() if isinstance(k, bytes) else k for k in keys]
        if vals:
            vals = [v.decode() if isinstance(v, bytes) else v for v in vals]
        is_str = vals_s is not None or isinstance(default, str)
        if default is None:  # spec defaults per value type
            default = "_Unused" if is_str else (
                -1 if vals and isinstance(vals[0], int) else -0.0)
        return cls(keys or [], vals or [], default, is_str)

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(LabelEncoderMilli(self.keys, self.values,
                                            self.default,
                                            self.value_is_string),
                          inputs[0])]


@register("Binarizer")
@dataclass
class Binarizer(Operation):
    threshold: float = 0.0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("threshold", 0.0))

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(BinarizerMilli(self.threshold), inputs[0])]


@register("ArrayFeatureExtractor")
@dataclass
class ArrayFeatureExtractor(Operation):
    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(ArrayFeatureExtractorMilli(),
                          inputs[0], inputs[1])]


@register("TreeEnsemble")
@dataclass
class TreeEnsemble(Operation):
    attrs_dict: Dict = field(default_factory=dict)

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        keep = {}
        for name in ("n_targets", "aggregate_function", "post_transform",
                     "tree_roots", "nodes_featureids", "nodes_modes",
                     "nodes_splits", "nodes_truenodeids",
                     "nodes_falsenodeids", "nodes_trueleafs",
                     "nodes_falseleafs", "leaf_targetids", "leaf_weights",
                     "membership_values",
                     "nodes_missing_value_tracks_true"):
            v = attrs.t(name)
            if v is None:
                v = attrs.i(name, None)
            if v is not None:
                keep[name] = (np.asarray(v)
                              if not isinstance(v, int) else v)
        return cls(keep)

    def lower(self, ctx, inputs, n_outputs):
        return [ctx.emit1(TreeEnsembleMilli(self.attrs_dict), inputs[0])]


def _optim_cls(kind, per_out):
    @dataclass
    class _Optim(Operation):
        norm_coefficient: float = 0.0
        epsilon: float = 1e-6
        decay_factor: float = 0.0
        alpha: float = 0.9
        beta: float = 0.999
        mode: str = "standard"
        norm_coefficient_post: float = 0.0
        n_tensors: int = 1

        @classmethod
        def from_onnx(cls, node, attrs, opset):
            n_in = sum(1 for n in node.input if n)
            groups = 3 if kind in ("adagrad", "momentum") else 4
            return cls(attrs.f("norm_coefficient", 0.0),
                       attrs.f("epsilon", 1e-6),
                       attrs.f("decay_factor", 0.0),
                       attrs.f("alpha", 0.9 if kind != "momentum"
                               else attrs.f("alpha", 0.9)),
                       attrs.f("beta", 0.999 if kind != "momentum"
                               else attrs.f("beta", 1.0)),
                       attrs.s("mode", "standard"),
                       attrs.f("norm_coefficient_post", 0.0),
                       (n_in - 2) // groups)

        def lower(self, ctx, inputs, n_outputs):
            return ctx.emit(
                TrainingOptimizerMilli(
                    kind, self.n_tensors, self.norm_coefficient,
                    self.epsilon, self.decay_factor, self.alpha, self.beta,
                    self.mode, self.norm_coefficient_post),
                *inputs, n_outputs=per_out * self.n_tensors)[:n_outputs]

    _Optim.__name__ = kind.capitalize()
    return _Optim


register("Adagrad")(_optim_cls("adagrad", 2))
register("Momentum")(_optim_cls("momentum", 2))
register("Adam")(_optim_cls("adam", 3))


@register("TfIdfVectorizer")
@dataclass
class TfIdfVectorizer(Operation):
    max_gram_length: int = 1
    max_skip_count: int = 0
    min_gram_length: int = 1
    mode: str = "TF"
    ngram_counts: tuple = ()
    ngram_indexes: tuple = ()
    pool_int64s: tuple = ()
    weights: Optional[tuple] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        w = attrs.floats("weights", None)
        return cls(attrs.i("max_gram_length", 1),
                   attrs.i("max_skip_count", 0),
                   attrs.i("min_gram_length", 1),
                   attrs.s("mode", "TF"),
                   tuple(attrs.ints("ngram_counts", []) or []),
                   tuple(attrs.ints("ngram_indexes", []) or []),
                   tuple(attrs.ints("pool_int64s", []) or []),
                   tuple(w) if w is not None else None)

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops.extra import TfIdfVectorizerMilli

        return [ctx.emit1(TfIdfVectorizerMilli(
            self.max_gram_length, self.max_skip_count,
            self.min_gram_length, self.mode, self.ngram_counts,
            self.ngram_indexes, self.pool_int64s, self.weights),
            inputs[0])]
