"""Long-tail milli ops (LRN, Det, DynamicQuantizeLinear, Bernoulli,
windows, Unique, Compress, the string and ai.onnx.ml ops, the training
optimizers, TfIdfVectorizer, Dropout) and the PyTorch lowerings of those
that run on tensors.

The classes are the port's copy of whisper_tensor_tpu/milli/ops/extra.py
(numpy `eval` and shape inference; no `to_jax`) without DFT, which waits
for the spectral ops (symbolic_graph/ops/not_ported.py). The string ops
and the `ai.onnx.ml` ops have no lowering: a graph that holds one runs
in the host interpreter (SymbolicGraph.needs_host_eval).

Random draws follow the oracle's numpy generators bit for bit: Bernoulli
(default_rng) and training-mode Dropout (the legacy seeded generator)
draw their uniforms on the host from the op's seed and compare them on
the device, so a seeded graph gives the oracle's answer on every device.
"""

from __future__ import annotations

import re as _re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ...dtype import DType, to_device, to_torch
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering, need_static
from .lowering_common import up, widen


def _numeric_all(infos):
    return all(i is None or i.level is Level.NUMERIC for i in infos) and \
        infos and infos[0] is not None


@dataclass
class LRNMilli(MilliOp):
    """Local response normalization across channels (axis 1)."""

    alpha: float = 1e-4
    beta: float = 0.75
    bias: float = 1.0
    size: int = 1
    KIND = "LRN"

    def _lrn(self, xp, x):
        xf = x.astype(np.float32)
        sq = xf * xf
        C = x.shape[1]
        half_lo = (self.size - 1) // 2
        half_hi = self.size // 2
        acc = None
        for off in range(-half_lo, half_hi + 1):
            lo = max(0, -off)
            hi = min(C, C - off)
            pads = [(0, 0)] * x.ndim
            pads[1] = (max(0, off) + (C - hi), lo)
            # shifted window sum via pad+slice keeps it xp-generic
            sl = [slice(None)] * x.ndim
            sl[1] = slice(lo, hi)
            shifted = xp.pad(sq[tuple(sl)],
                             [(0, 0), (max(0, off), max(0, -off))]
                             + [(0, 0)] * (x.ndim - 2))
            acc = shifted if acc is None else acc + shifted
        denom = (self.bias + (self.alpha / self.size) * acc) ** self.beta
        return (xf / denom).astype(x.dtype)

    def eval(self, inputs):
        return [self._lrn(np, inputs[0])]


    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        return [i.forget_value()]


@dataclass
class DetMilli(MilliOp):
    KIND = "Det"

    def eval(self, inputs):
        return [np.linalg.det(inputs[0].astype(np.float64)).astype(
            inputs[0].dtype)]


    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        if i.rank is not None:
            return [TensorInfo.ranked(i.dtype, max(0, i.rank - 2))]
        return [TensorInfo.minimal(i.dtype)]


@dataclass
class DynamicQuantizeLinearMilli(MilliOp):
    """x -> (y u8, y_scale f32, y_zero_point u8) per the ONNX formula
    (range widened to include 0, round-half-to-even)."""

    KIND = "DynamicQuantizeLinear"

    def _dql(self, xp, x):
        xf = x.astype(np.float32)
        mn = xp.minimum(xp.min(xf), 0.0)
        mx = xp.maximum(xp.max(xf), 0.0)
        scale = (mx - mn) / 255.0
        zp_f = xp.where(scale > 0, xp.clip(xp.rint(-mn / scale), 0.0, 255.0),
                        xp.zeros_like(scale))
        y = xp.clip(xp.rint(xp.where(scale > 0, xf / scale, xf)) + zp_f,
                    0.0, 255.0)
        return y, scale, zp_f

    def eval(self, inputs):
        y, scale, zp = self._dql(np, inputs[0])
        return [y.astype(np.uint8), np.float32(scale),
                np.asarray(zp, dtype=np.uint8)]


    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(o) for o in self.eval([i.value])]
        return [TensorInfo(DType.U8, min(i.level, Level.SHAPED),
                           shape=i.shape, rank_=i.rank_),
                TensorInfo.shaped(DType.F32, []),
                TensorInfo.shaped(DType.U8, [])]


@dataclass
class BernoulliMilli(MilliOp):
    """Elementwise Bernoulli draw. Seeded; conformance cases use
    p in {0,1} so both backends and any seed agree."""

    dtype: Optional[DType] = None
    seed: Optional[float] = None
    KIND = "Bernoulli"

    def eval(self, inputs):
        p = inputs[0]
        rng = np.random.default_rng(
            int(self.seed) if self.seed is not None else 0)
        draw = rng.random(p.shape) < p.astype(np.float64)
        dt = (self.dtype.to_numpy() if self.dtype is not None
              else p.dtype)
        return [draw.astype(dt)]


    def infer(self, infos):
        i = infos[0]
        dt = self.dtype or i.dtype
        return [TensorInfo(dt, min(i.level, Level.SHAPED), shape=i.shape,
                           rank_=i.rank_)]


@dataclass
class WindowMilli(MilliOp):
    """Hann/Hamming/Blackman window of static size (ONNX-17)."""

    kind: str = "hann"
    periodic: bool = True
    dtype: DType = DType.F32
    KIND = "Window"

    def _window(self, n: int) -> np.ndarray:
        N = n if self.periodic else n - 1
        i = np.arange(n, dtype=np.float64)
        if N <= 0:
            w = np.ones(n)
        elif self.kind == "hann":
            w = 0.5 - 0.5 * np.cos(2 * np.pi * i / N)
        elif self.kind == "hamming":
            # ONNX uses 25/46 (not .54) per the spec definition
            w = 25.0 / 46.0 - (21.0 / 46.0) * np.cos(2 * np.pi * i / N)
        else:  # blackman
            w = (0.42 - 0.5 * np.cos(2 * np.pi * i / N)
                 + 0.08 * np.cos(4 * np.pi * i / N))
        return w.astype(self.dtype.to_numpy())

    def eval(self, inputs):
        return [self._window(int(np.asarray(inputs[0]).reshape(())))]


    def infer(self, infos):
        i = infos[0]
        if i is not None and i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        return [TensorInfo.ranked(self.dtype, 1)]


@dataclass
class UniqueMilli(MilliOp):
    """ONNX Unique (4 outputs). Data-dependent shapes: oracle-only."""

    axis: Optional[int] = None
    sorted: bool = True
    KIND = "Unique"

    def eval(self, inputs):
        x = inputs[0]
        y, idx, inv, cnt = np.unique(
            x, return_index=True, return_inverse=True, return_counts=True,
            axis=self.axis)
        if not self.sorted:
            order = np.argsort(idx, kind="stable")
            rank = np.empty_like(order)
            rank[order] = np.arange(len(order))
            y = y[order] if self.axis is None else np.take(y, order,
                                                           axis=self.axis)
            idx = idx[order]
            inv = rank[inv]
            cnt = cnt[order]
        if self.axis is None:
            inv = inv.reshape(-1)
        return [y, idx.astype(np.int64), inv.astype(np.int64),
                cnt.astype(np.int64)]

    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(o) for o in self.eval([i.value])]
        r = i.rank if self.axis is not None else 1
        return [TensorInfo.ranked(i.dtype, r) if r is not None
                else TensorInfo.minimal(i.dtype),
                TensorInfo.ranked(DType.I64, 1),
                TensorInfo.ranked(DType.I64, 1),
                TensorInfo.ranked(DType.I64, 1)]


@dataclass
class CompressMilli(MilliOp):
    """Select slices by a bool mask (data-dependent: oracle-only)."""

    axis: Optional[int] = None
    KIND = "Compress"

    def eval(self, inputs):
        return [np.compress(inputs[1].astype(bool), inputs[0],
                            axis=self.axis)]

    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(
                self.eval([f.value for f in infos])[0])]
        r = 1 if self.axis is None else i.rank
        return [TensorInfo.ranked(i.dtype, r) if r is not None
                else TensorInfo.minimal(i.dtype)]


# ---------------------------------------------------------------------------
# string ops (oracle-only; STRING dtype is numpy object)
# ---------------------------------------------------------------------------

@dataclass
class StringConcatMilli(MilliOp):
    KIND = "StringConcat"

    def eval(self, inputs):
        a, b = (np.asarray(inputs[0], dtype=object),
                np.asarray(inputs[1], dtype=object))
        a, b = np.broadcast_arrays(a, b)
        out = np.empty(a.shape, dtype=object)
        for i in np.ndindex(a.shape):
            out[i] = str(a[i]) + str(b[i])
        return [out]

    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(
                self.eval([f.value for f in infos])[0], DType.STRING)]
        return [TensorInfo.minimal(DType.STRING)]


@dataclass
class StringSplitMilli(MilliOp):
    delimiter: Optional[str] = None
    maxsplit: Optional[int] = None
    KIND = "StringSplit"

    def eval(self, inputs):
        x = np.asarray(inputs[0], dtype=object)
        ms = -1 if self.maxsplit is None else self.maxsplit
        parts = [([] if str(v) == "" else
                  (str(v).split(self.delimiter, ms) if self.delimiter
                   else str(v).split(None, ms))) for v in x.reshape(-1)]
        n = max((len(p) for p in parts), default=0)
        out = np.full((x.size, n), "", dtype=object)
        cnt = np.zeros(x.size, dtype=np.int64)
        for i, p in enumerate(parts):
            cnt[i] = len(p)
            out[i, :len(p)] = p
        return [out.reshape(x.shape + (n,)),
                cnt.reshape(x.shape)]

    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(o, DType.STRING if k == 0 else None)
                    for k, o in enumerate(self.eval([i.value]))]
        return [TensorInfo.minimal(DType.STRING),
                TensorInfo.minimal(DType.I64)]


@dataclass
class StringNormalizerMilli(MilliOp):
    case_change_action: str = "NONE"
    is_case_sensitive: bool = False
    locale: Optional[str] = None
    stopwords: Optional[List[str]] = None
    KIND = "StringNormalizer"

    def eval(self, inputs):
        x = np.asarray(inputs[0], dtype=object)
        flat = [str(v) for v in x.reshape(-1)]
        if self.stopwords:
            if self.is_case_sensitive:
                stop = set(self.stopwords)
                flat = [v for v in flat if v not in stop]
            else:
                stop = {s.lower() for s in self.stopwords}
                flat = [v for v in flat if v.lower() not in stop]
        if self.case_change_action == "LOWER":
            flat = [v.lower() for v in flat]
        elif self.case_change_action == "UPPER":
            flat = [v.upper() for v in flat]
        if not flat:
            flat = [""]
        out = np.asarray(flat, dtype=object)
        if x.ndim == 2:
            out = out.reshape(1, -1)
        return [out]

    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(self.eval([i.value])[0],
                                       DType.STRING)]
        return [TensorInfo.minimal(DType.STRING)]


@dataclass
class RegexFullMatchMilli(MilliOp):
    pattern: str = ""
    KIND = "RegexFullMatch"

    def eval(self, inputs):
        x = np.asarray(inputs[0], dtype=object)
        pat = _re.compile(self.pattern)
        out = np.empty(x.shape, dtype=bool)
        for i in np.ndindex(x.shape):
            out[i] = pat.fullmatch(str(x[i])) is not None
        return [out]

    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        return [TensorInfo(DType.BOOL, min(i.level, Level.SHAPED),
                           shape=i.shape, rank_=i.rank_)]


# ---------------------------------------------------------------------------
# ai.onnx.ml
# ---------------------------------------------------------------------------

@dataclass
class LabelEncoderMilli(MilliOp):
    keys: List = field(default_factory=list)
    values: List = field(default_factory=list)
    default: object = None
    value_is_string: bool = False
    KIND = "LabelEncoder"

    def eval(self, inputs):
        x = np.asarray(inputs[0])
        table = dict(zip(self.keys, self.values))
        flat = []
        for v in x.reshape(-1):
            k = str(v) if isinstance(v, (str, np.str_)) else (
                float(v) if np.asarray(v).dtype.kind == "f" else int(v))
            flat.append(table.get(k, self.default))
        if self.value_is_string:
            out = np.asarray(flat, dtype=object)
        else:
            out = np.asarray(flat)
        return [out.reshape(x.shape)]

    def infer(self, infos):
        i = infos[0]
        dt = DType.STRING if self.value_is_string else None
        if _numeric_all(infos):
            return [TensorInfo.numeric(self.eval([i.value])[0], dt)]
        return [TensorInfo.minimal(dt or DType.I64)]


@dataclass
class BinarizerMilli(MilliOp):
    threshold: float = 0.0
    KIND = "Binarizer"

    def eval(self, inputs):
        x = inputs[0]
        return [(x > x.dtype.type(self.threshold)).astype(x.dtype)]


    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        return [i.forget_value()]


@dataclass
class ArrayFeatureExtractorMilli(MilliOp):
    KIND = "ArrayFeatureExtractor"

    def eval(self, inputs):
        x, idx = inputs[0], np.asarray(inputs[1]).reshape(-1)
        return [np.take(x, idx, axis=-1)]


    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(
                self.eval([f.value for f in infos])[0])]
        return [TensorInfo.ranked(i.dtype, i.rank)
                if i.rank is not None else TensorInfo.minimal(i.dtype)]


@dataclass
class TreeEnsembleMilli(MilliOp):
    """ai.onnx.ml v5 TreeEnsemble (regressor form). Oracle-only walk of
    the node tables; covers the official set_membership/single_tree
    cases."""

    attrs: Dict = field(default_factory=dict)
    KIND = "TreeEnsemble"

    def eval(self, inputs):
        a = self.attrs
        x = np.asarray(inputs[0], dtype=np.float64)
        N = x.shape[0]
        n_targets = int(a["n_targets"])
        agg = int(a.get("aggregate_function", 1))
        post = int(a.get("post_transform", 0))
        roots = np.asarray(a["tree_roots"], dtype=np.int64)
        feat = np.asarray(a["nodes_featureids"], dtype=np.int64)
        modes = np.asarray(a["nodes_modes"], dtype=np.int64)
        splits = np.asarray(a["nodes_splits"], dtype=np.float64)
        tleft = np.asarray(a["nodes_truenodeids"], dtype=np.int64)
        fright = np.asarray(a["nodes_falsenodeids"], dtype=np.int64)
        tru_leaf = np.asarray(a["nodes_trueleafs"], dtype=np.int64)
        fal_leaf = np.asarray(a["nodes_falseleafs"], dtype=np.int64)
        leaf_tgt = np.asarray(a["leaf_targetids"], dtype=np.int64)
        leaf_w = np.asarray(a["leaf_weights"], dtype=np.float64)
        members = a.get("membership_values")
        if members is not None:
            members = np.asarray(members, dtype=np.float64)
        nan_true = np.asarray(
            a.get("nodes_missing_value_tracks_true",
                  np.zeros(len(feat))), dtype=np.int64)

        mem_pos = 0  # membership values are consumed in node order

        def node_member_count(i):
            # count NaN-terminated run for SET_MEMBER nodes (mode 6)
            return 0

        # precompute membership runs: one NaN-terminated run per
        # BRANCH_MEMBER node, in node index order
        runs = {}
        if members is not None:
            pos = 0
            for i in range(len(modes)):
                if modes[i] == 6:
                    vals = []
                    while pos < len(members) and not np.isnan(members[pos]):
                        vals.append(members[pos])
                        pos += 1
                    pos += 1  # skip NaN terminator
                    runs[i] = set(vals)

        out = np.zeros((N, n_targets))
        cnt = np.zeros((N, n_targets))
        for n in range(N):
            for root in roots:
                i = int(root)
                is_leaf = False
                while not is_leaf:
                    f = x[n, feat[i]]
                    m = modes[i]
                    if np.isnan(f):
                        go_true = bool(nan_true[i])
                    elif m == 0:
                        go_true = f <= splits[i]
                    elif m == 1:
                        go_true = f < splits[i]
                    elif m == 2:
                        go_true = f >= splits[i]
                    elif m == 3:
                        go_true = f > splits[i]
                    elif m == 4:
                        go_true = f == splits[i]
                    elif m == 5:
                        go_true = f != splits[i]
                    elif m == 6:
                        go_true = f in runs.get(i, set())
                    else:
                        raise NotImplementedError(f"tree mode {m}")
                    if go_true:
                        is_leaf = bool(tru_leaf[i])
                        i = int(tleft[i])
                    else:
                        is_leaf = bool(fal_leaf[i])
                        i = int(fright[i])
                t = int(leaf_tgt[i])
                w = leaf_w[i]
                if agg == 0:  # AVERAGE
                    out[n, t] += w
                    cnt[n, t] += 1
                elif agg == 2:  # MIN
                    out[n, t] = w if cnt[n, t] == 0 else min(out[n, t], w)
                    cnt[n, t] += 1
                elif agg == 3:  # MAX
                    out[n, t] = w if cnt[n, t] == 0 else max(out[n, t], w)
                    cnt[n, t] += 1
                else:  # SUM
                    out[n, t] += w
        if agg == 0:
            out = out / np.maximum(cnt, 1)
        if post != 0:
            raise NotImplementedError("TreeEnsemble post_transform")
        return [out.astype(np.float32)]

    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        return [TensorInfo.ranked(DType.F32, 2)]


# ---------------------------------------------------------------------------
# ai.onnx.preview.training optimizers
# ---------------------------------------------------------------------------

@dataclass
class TrainingOptimizerMilli(MilliOp):
    """Adagrad / Momentum / Adam one-step update (ONNX preview
    training domain). Inputs: R (lr), T (step), then per-tensor groups;
    outputs the updated tensors. n_tensors static."""

    kind: str = "adagrad"
    n_tensors: int = 1
    norm_coefficient: float = 0.0
    epsilon: float = 1e-6
    decay_factor: float = 0.0
    alpha: float = 0.9
    beta: float = 0.999
    mode: str = "standard"   # momentum: standard | nesterov
    norm_coefficient_post: float = 0.0
    KIND = "TrainingOptimizer"

    def eval(self, inputs):
        r = float(np.asarray(inputs[0]).reshape(()))
        t = int(np.asarray(inputs[1]).reshape(()))
        n = self.n_tensors
        outs = []
        if self.kind == "adagrad":
            for j in range(n):
                x = inputs[2 + j].astype(np.float64)
                g = inputs[2 + n + j].astype(np.float64)
                h = inputs[2 + 2 * n + j].astype(np.float64)
                r_t = r / (1 + t * self.decay_factor)
                gr = g + self.norm_coefficient * x
                h_new = h + gr * gr
                x_new = x - r_t * gr / (np.sqrt(h_new) + self.epsilon)
                outs.append(x_new)
                outs.append(h_new)
            # ONNX output order: all X' then all H'
            xs = outs[0::2]
            hs = outs[1::2]
            res = xs + hs
        elif self.kind == "momentum":
            for j in range(n):
                x = inputs[2 + j].astype(np.float64)
                g = inputs[2 + n + j].astype(np.float64)
                v = inputs[2 + 2 * n + j].astype(np.float64)
                beta_adj = self.beta if t > 0 else 1.0
                gr = g + self.norm_coefficient * x
                v_new = self.alpha * v + beta_adj * gr
                if self.mode == "nesterov":
                    x_new = x - r * (gr + self.alpha * v_new)
                else:
                    x_new = x - r * v_new
                outs.append(x_new)
                outs.append(v_new)
            res = outs[0::2] + outs[1::2]
        elif self.kind == "adam":
            for j in range(n):
                x = inputs[2 + j].astype(np.float64)
                g = inputs[2 + n + j].astype(np.float64)
                v = inputs[2 + 2 * n + j].astype(np.float64)
                h = inputs[2 + 3 * n + j].astype(np.float64)
                gr = g + self.norm_coefficient * x
                v_new = self.alpha * v + (1 - self.alpha) * gr
                h_new = self.beta * h + (1 - self.beta) * gr * gr
                r_adj = (r * np.sqrt(1 - self.beta ** t)
                         / (1 - self.alpha ** t) if t > 0 else r)
                x_new = x - r_adj * v_new / (np.sqrt(h_new) + self.epsilon)
                x_new = (1 - self.norm_coefficient_post) * x_new
                outs.extend([x_new, v_new, h_new])
            res = outs[0::3] + outs[1::3] + outs[2::3]
        else:
            raise NotImplementedError(self.kind)
        return [o.astype(np.float32) for o in res]

    def infer(self, infos):
        if _numeric_all(infos):
            return [TensorInfo.numeric(o) for o in self.eval(
                [f.value for f in infos])]
        per = 2 if self.kind in ("adagrad", "momentum") else 3
        outs = []
        for j in range(per * self.n_tensors):
            outs.append(TensorInfo.minimal(DType.F32))
        return outs


@dataclass
class TfIdfVectorizerMilli(MilliOp):
    """ONNX TfIdfVectorizer (TF/IDF/TFIDF over skip-n-grams).
    Oracle-only: dictionary-driven counting (official corpus
    test_tfidfvectorizer_*)."""

    max_gram_length: int = 1
    max_skip_count: int = 0
    min_gram_length: int = 1
    mode: str = "TF"
    ngram_counts: tuple = ()
    ngram_indexes: tuple = ()
    pool_int64s: tuple = ()
    weights: Optional[tuple] = None
    KIND = "TfIdfVectorizer"

    def _pool(self):
        """{(gram tuple): output column}"""
        table = {}
        counts = list(self.ngram_counts) + [len(self.pool_int64s)]
        idx_pos = 0
        for level in range(len(self.ngram_counts)):
            n = level + 1
            start, end = counts[level], counts[level + 1]
            section = self.pool_int64s[start:end]
            for off in range(0, len(section), n):
                gram = tuple(section[off:off + n])
                table[gram] = self.ngram_indexes[idx_pos]
                idx_pos += 1
        return table

    def eval(self, inputs):
        x = np.asarray(inputs[0], dtype=np.int64)
        was_1d = x.ndim == 1
        if was_1d:
            x = x[None]
        N, C = x.shape
        W = max(self.ngram_indexes) + 1 if self.ngram_indexes else 0
        out = np.zeros((N, W), np.float32)
        table = self._pool()
        for r in range(N):
            row = x[r]
            for n in range(self.min_gram_length,
                           self.max_gram_length + 1):
                skips = range(self.max_skip_count + 1) if n > 1 else [0]
                for s in skips:
                    stride = s + 1
                    span = (n - 1) * stride
                    for i in range(0, C - span):
                        gram = tuple(int(row[i + j * stride])
                                     for j in range(n))
                        col = table.get(gram)
                        if col is not None:
                            out[r, col] += 1.0
        if self.mode in ("IDF", "TFIDF"):
            w = (np.asarray(self.weights, np.float32)
                 if self.weights is not None else np.ones(W, np.float32))
            if self.mode == "IDF":
                out = (out > 0).astype(np.float32) * w
            else:
                out = out * w
        return [out[0] if was_1d else out]

    def infer(self, infos):
        i = infos[0]
        if _numeric_all(infos):
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        return [TensorInfo.ranked(DType.F32, i.rank)
                if i.rank is not None else TensorInfo.minimal(DType.F32)]


@dataclass
class DropoutMilli(MilliOp):
    """ONNX-13 Dropout: x [, ratio [, training_mode]] -> y [, mask].
    Inference (or ratio 0): identity + all-true mask. Training: the
    official corpus' legacy numpy draw (np.random.seed(seed);
    uniform >= ratio), oracle-only — the jit path serves inference."""

    seed: Optional[int] = None
    n_out: int = 1
    KIND = "Dropout"

    def _mode(self, inputs):
        ratio = (float(np.asarray(inputs[1]).reshape(()))
                 if len(inputs) > 1 and inputs[1] is not None else 0.5)
        training = (bool(np.asarray(inputs[2]).reshape(()))
                    if len(inputs) > 2 and inputs[2] is not None else False)
        return ratio, training

    def eval(self, inputs):
        x = inputs[0]
        ratio, training = self._mode(inputs)
        if not training or ratio == 0.0:
            return [x.copy(), np.ones(x.shape, bool)][:self.n_out]
        np.random.seed(int(self.seed) if self.seed is not None else 0)
        mask = np.random.uniform(0.0, 1.0, x.shape) >= ratio
        y = (mask * x / (1.0 - ratio)).astype(x.dtype)
        return [y, mask][:self.n_out]


    def infer(self, infos):
        x = infos[0]
        outs = [x.forget_value()]
        if self.n_out > 1:
            outs.append(TensorInfo(DType.BOOL, min(x.level, Level.SHAPED),
                                   shape=x.shape, rank_=x.rank_))
        return outs


# -- lowerings ----------------------------------------------------------


@lowering("LRN")
def lrn(op, inputs, static, device):
    x = inputs[0]
    xf = x.float()
    sq = xf * xf
    c = x.shape[1]
    acc = torch.zeros_like(sq)
    for off in range(-((op.size - 1) // 2), op.size // 2 + 1):
        # acc[:, k] += sq[:, k + off] where 0 <= k + off < c
        lo, hi = max(0, -off), min(c, c - off)
        if hi > lo:
            acc.narrow(1, lo, hi - lo).add_(sq.narrow(1, lo + off, hi - lo))
    denom = (op.bias + (op.alpha / op.size) * acc) ** op.beta
    return [(xf / denom).to(x.dtype)]


@lowering("Det")
def det(op, inputs, static, device):
    x = inputs[0]
    return [torch.linalg.det(x.to(torch.float64)).to(x.dtype)]


@lowering("DynamicQuantizeLinear")
def dynamic_quantize_linear(op, inputs, static, device):
    xf = inputs[0].float()
    mn = torch.clamp(xf.min(), max=0.0)
    mx = torch.clamp(xf.max(), min=0.0)
    scale = (mx - mn) / 255.0
    pos = scale > 0
    zp = torch.where(pos, torch.clamp(torch.round(-mn / scale), 0, 255),
                     torch.zeros_like(scale))
    y = torch.clamp(torch.round(torch.where(pos, xf / scale, xf)) + zp,
                    0, 255)
    return [y.to(torch.uint8), scale.to(torch.float32), zp.to(torch.uint8)]


@lowering("Bernoulli")
def bernoulli(op, inputs, static, device):
    p = inputs[0]
    rng = np.random.default_rng(int(op.seed) if op.seed is not None else 0)
    u = to_device(rng.random(tuple(p.shape)), p.device)
    draw = u < p.to(torch.float64)
    dt = to_torch(op.dtype) if op.dtype is not None else p.dtype
    return [draw.to(dt)]


@lowering("Window")
def window(op, inputs, static, device):
    n = int(need_static(static, 0, "Window").reshape(()))
    return [to_device(op._window(n), device)]


@lowering("Unique")
def unique(op, inputs, static, device):
    x = inputs[0]
    xs = widen(x)
    flat = xs.reshape(-1) if op.axis is None else xs
    y, inv, cnt = torch.unique(flat, sorted=True, return_inverse=True,
                               return_counts=True, dim=op.axis)
    n = flat.shape[0 if op.axis is None else op.axis]
    pos = torch.arange(n, device=x.device)
    first = torch.full((cnt.shape[0],), n, dtype=torch.long,
                       device=x.device).scatter_reduce(
        0, inv.reshape(-1), pos, "amin")
    if not op.sorted:
        order = torch.argsort(first, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.shape[0], device=x.device)
        y = y[order] if op.axis is None else y.index_select(op.axis, order)
        first, inv, cnt = first[order], rank[inv], cnt[order]
    return [y.to(x.dtype), first.to(torch.int64),
            inv.reshape(-1).to(torch.int64), cnt.to(torch.int64)]


@lowering("Compress")
def compress(op, inputs, static, device):
    x, cond = inputs
    idx = torch.nonzero(cond.reshape(-1).bool()).reshape(-1)
    if op.axis is None:
        return [x.reshape(-1).index_select(0, idx)]
    return [x.index_select(op.axis % x.ndim, idx)]


@lowering("TrainingOptimizer")
def training_optimizer(op, inputs, static, device):
    r = float(need_static(static, 0, op.kind).reshape(()))
    t = int(need_static(static, 1, op.kind).reshape(()))
    n = op.n_tensors
    grp = [[v.to(torch.float64) for v in inputs[2 + k * n:2 + (k + 1) * n]]
           for k in range((len(inputs) - 2) // n)]
    outs = []
    if op.kind == "adagrad":
        xs, hs = [], []
        for x, g, h in zip(*grp[:3]):
            r_t = r / (1 + t * op.decay_factor)
            gr = g + op.norm_coefficient * x
            h_new = h + gr * gr
            xs.append(x - r_t * gr / (torch.sqrt(h_new) + op.epsilon))
            hs.append(h_new)
        outs = xs + hs
    elif op.kind == "momentum":
        xs, vs = [], []
        for x, g, v in zip(*grp[:3]):
            beta_adj = op.beta if t > 0 else 1.0
            gr = g + op.norm_coefficient * x
            v_new = op.alpha * v + beta_adj * gr
            xs.append(x - r * (gr + op.alpha * v_new)
                      if op.mode == "nesterov" else x - r * v_new)
            vs.append(v_new)
        outs = xs + vs
    elif op.kind == "adam":
        xs, vs, hs = [], [], []
        for x, g, v, h in zip(*grp[:4]):
            gr = g + op.norm_coefficient * x
            v_new = op.alpha * v + (1 - op.alpha) * gr
            h_new = op.beta * h + (1 - op.beta) * gr * gr
            r_adj = (r * np.sqrt(1 - op.beta ** t) / (1 - op.alpha ** t)
                     if t > 0 else r)
            x_new = x - r_adj * v_new / (torch.sqrt(h_new) + op.epsilon)
            xs.append((1 - op.norm_coefficient_post) * x_new)
            vs.append(v_new)
            hs.append(h_new)
        outs = xs + vs + hs
    else:
        raise NotImplementedError(op.kind)
    return [o.to(torch.float32) for o in outs]


@lowering("TfIdfVectorizer")
def tfidf_vectorizer(op, inputs, static, device):
    x = inputs[0].to(torch.int64)
    was_1d = x.ndim == 1
    if was_1d:
        x = x[None]
    rows, c = x.shape
    width = max(op.ngram_indexes) + 1 if op.ngram_indexes else 0
    out = torch.zeros((rows, width), dtype=torch.float32, device=x.device)
    by_len = {}
    for gram, col in op._pool().items():
        by_len.setdefault(len(gram), []).append((gram, col))
    for n in range(op.min_gram_length, op.max_gram_length + 1):
        if n not in by_len:
            continue
        grams = torch.tensor([g for g, _ in by_len[n]], device=x.device)
        cols = torch.tensor([k for _, k in by_len[n]], device=x.device)
        for s in (range(op.max_skip_count + 1) if n > 1 else [0]):
            span = (n - 1) * (s + 1)
            if c - span <= 0:
                continue
            # (rows, positions, n): the n-gram starting at each position
            win = torch.stack([x[:, j * (s + 1):j * (s + 1) + c - span]
                               for j in range(n)], dim=-1)
            hits = (win[:, :, None, :] == grams[None, None]).all(-1)
            out.index_add_(1, cols, hits.sum(1).to(torch.float32))
    if op.mode in ("IDF", "TFIDF"):
        w = (torch.tensor(op.weights, dtype=torch.float32, device=x.device)
             if op.weights is not None else torch.ones(width,
                                                       device=x.device))
        out = (out > 0).to(torch.float32) * w if op.mode == "IDF" \
            else out * w
    return [out[0] if was_1d else out]


def _legacy_uniform(seed, shape) -> np.ndarray:
    """The oracle's training-mode draw: numpy's legacy seeded generator
    (a private RandomState, so the global one is left alone)."""
    return np.random.RandomState(seed).uniform(0.0, 1.0, shape)


@lowering("Dropout")
def dropout(op, inputs, static, device):
    x = inputs[0]
    ratio = (float(need_static(static, 1, "Dropout").reshape(()))
             if len(inputs) > 1 and inputs[1] is not None else 0.5)
    training = (bool(need_static(static, 2, "Dropout").reshape(()))
                if len(inputs) > 2 and inputs[2] is not None else False)
    if not training or ratio == 0.0:
        return [x.clone(), torch.ones(x.shape, dtype=torch.bool,
                                      device=x.device)][:op.n_out]
    u = _legacy_uniform(int(op.seed) if op.seed is not None else 0,
                        tuple(x.shape))
    mask = to_device(u, x.device) >= ratio
    y = (mask * up(x).to(torch.float64) / (1.0 - ratio)).to(x.dtype)
    return [y, mask][:op.n_out]
