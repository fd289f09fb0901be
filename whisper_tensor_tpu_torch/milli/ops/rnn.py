"""LSTM, GRU and RNN: the milli op classes and their PyTorch lowerings.

The classes are the port's copy of whisper_tensor_tpu/milli/ops/rnn.py
(ONNX semantics: LSTM's iofc gate order with peepholes, GRU's zrh order
and `linear_before_reset`, the vanilla RNN's tanh or relu; numpy `eval`
and shape inference; no `to_jax`). As in the reference, the symbolic
ops refuse custom activations and the `clip` attribute is not read.

The lowering (`_recurrence`) is the counterpart of the reference's
`to_jax` bodies (:117, :287, :420), which scan each direction with
lax.scan: here a Python loop over the time steps runs each direction on
the device with plain torch ops in f32 (f32 matmuls at full precision:
TF32 is off, device.py), the reverse direction walking the sequence
backwards, rows past their `sequence_lens` keeping their state and
emitting zeros. It also takes what the reference leaves to its oracle
(`layout=1` and LSTM's peepholes), following `eval`: batch-first input
and output, LSTM's initial states transposed under layout=1 (the
vanilla RNN's are read as given, as its `eval` reads them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


@dataclass
class LstmMilli(MilliOp):
    """inputs: X(S,B,I), W(nd,4H,I), R(nd,4H,H)[, B(nd,8H), seq_lens(B),
    initial_h(nd,B,H), initial_c(nd,B,H)].
    outputs: Y(S,nd,B,H), Y_h(nd,B,H), Y_c(nd,B,H)."""

    hidden_size: int = 0
    direction: str = "forward"  # forward | reverse | bidirectional
    layout: int = 0             # 1 = batch-first (batchwise tests)
    KIND = "Lstm"
    N_OUTPUTS = 3

    def _dirs(self):
        if self.direction == "bidirectional":
            return [0, 1]
        return [1] if self.direction == "reverse" else [0]

    def eval(self, inputs):
        X = inputs[0].astype(np.float32)
        if self.layout:
            X = np.swapaxes(X, 0, 1)
        W = inputs[1].astype(np.float32)
        R = inputs[2].astype(np.float32)
        Bi = inputs[3].astype(np.float32) if len(inputs) > 3 and inputs[3] is not None else None
        seq_lens = inputs[4] if len(inputs) > 4 and inputs[4] is not None else None
        H = self.hidden_size
        S, Bn, I = X.shape
        nd = W.shape[0]
        h0 = (inputs[5].astype(np.float32) if len(inputs) > 5 and inputs[5] is not None
              else np.zeros((nd, Bn, H), np.float32))
        c0 = (inputs[6].astype(np.float32) if len(inputs) > 6 and inputs[6] is not None
              else np.zeros((nd, Bn, H), np.float32))
        if self.layout and len(inputs) > 5 and inputs[5] is not None:
            h0 = np.swapaxes(h0, 0, 1)
        if self.layout and len(inputs) > 6 and inputs[6] is not None:
            c0 = np.swapaxes(c0, 0, 1)
        P = (inputs[7].astype(np.float32)
             if len(inputs) > 7 and inputs[7] is not None else None)
        Y = np.zeros((S, nd, Bn, H), np.float32)
        Yh = np.zeros((nd, Bn, H), np.float32)
        Yc = np.zeros((nd, Bn, H), np.float32)
        for d in range(nd):
            rev = (self.direction == "reverse") or (d == 1)
            Wd, Rd = W[d], R[d]
            bias = Bi[d][:4 * H] + Bi[d][4 * H:] if Bi is not None else np.zeros(4 * H, np.float32)
            pi = P[d][0:H] if P is not None else 0.0
            po = P[d][H:2 * H] if P is not None else 0.0
            pf = P[d][2 * H:3 * H] if P is not None else 0.0
            h, c = h0[d].copy(), c0[d].copy()
            order = range(S - 1, -1, -1) if rev else range(S)
            for t in order:
                x = X[t]
                g = x @ Wd.T + h @ Rd.T + bias
                i = _sig(g[:, 0:H] + pi * c)
                f = _sig(g[:, 2 * H:3 * H] + pf * c)
                cc = np.tanh(g[:, 3 * H:4 * H])
                c_new = f * c + i * cc
                o = _sig(g[:, H:2 * H] + po * c_new)
                h_new = o * np.tanh(c_new)
                if seq_lens is not None:
                    active = (t < np.asarray(seq_lens).astype(np.int64))[:, None]
                    h_new = np.where(active, h_new, h)
                    c_new = np.where(active, c_new, c)
                    Y[t, d] = np.where(active, h_new, 0.0)
                else:
                    Y[t, d] = h_new
                h, c = h_new, c_new
            Yh[d], Yc[d] = h, c
        dt = inputs[0].dtype
        if self.layout:
            # layout=1: Y (B,S,nd,H); Y_h/Y_c (B,nd,H)
            return [Y.transpose(2, 0, 1, 3).astype(dt),
                    np.swapaxes(Yh, 0, 1).astype(dt),
                    np.swapaxes(Yc, 0, 1).astype(dt)]
        return [Y.astype(dt), Yh.astype(dt), Yc.astype(dt)]

    def infer(self, infos):
        vals = [i.value if i is not None and i.level is Level.NUMERIC else None
                for i in infos]
        if all(v is not None for v in vals[:3]) and all(
                v is not None or infos[k] is None for k, v in enumerate(vals)):
            try:
                outs = self.eval([v for v in vals])
                return [TensorInfo.numeric(o) for o in outs]
            except Exception:
                pass
        x = infos[0]
        dx = x.dims()
        nd = 2 if self.direction == "bidirectional" else 1
        H = self.hidden_size
        if getattr(self, "layout", 0):
            # batch-first layout transposes S/B in the outputs: RANKED
            n_out = getattr(self, "N_OUTPUTS", 2)
            return ([TensorInfo.ranked(x.dtype, 4)]
                    + [TensorInfo.ranked(x.dtype, 3)] * (n_out - 1))
        if dx is not None:
            from ...scalar_info import ScalarInfo

            S, Bn = dx[0], dx[1]
            return [TensorInfo.shaped(x.dtype, [S, ScalarInfo.of(nd), Bn, ScalarInfo.of(H)]),
                    TensorInfo.shaped(x.dtype, [ScalarInfo.of(nd), Bn, ScalarInfo.of(H)]),
                    TensorInfo.shaped(x.dtype, [ScalarInfo.of(nd), Bn, ScalarInfo.of(H)])]
        return [TensorInfo.minimal(x.dtype)] * 3


@dataclass
class GruMilli(MilliOp):
    """ONNX GRU (zrh gate order, linear_before_reset attr).
    inputs: X(S,B,I), W(nd,3H,I), R(nd,3H,H)[, B(nd,6H), seq_lens(B),
    initial_h(nd,B,H)].  outputs: Y(S,nd,B,H), Y_h(nd,B,H)."""

    hidden_size: int = 0
    direction: str = "forward"
    linear_before_reset: bool = False
    layout: int = 0             # 1 = batch-first (batchwise tests)
    KIND = "Gru"
    N_OUTPUTS = 2

    def _cell_np(self, x, h, Wd, Rd, wb, rb):
        H = self.hidden_size
        gx = x @ Wd.T + wb
        gh = h @ Rd.T + rb
        z = _sig(gx[:, 0:H] + gh[:, 0:H])
        r = _sig(gx[:, H:2 * H] + gh[:, H:2 * H])
        if self.linear_before_reset:
            hh = np.tanh(gx[:, 2 * H:] + r * gh[:, 2 * H:])
        else:
            hh = np.tanh(gx[:, 2 * H:] + (r * h) @ Rd[2 * H:].T
                         + rb[2 * H:])
        return (1 - z) * hh + z * h

    def eval(self, inputs):
        X = inputs[0].astype(np.float32)
        if self.layout:
            X = np.swapaxes(X, 0, 1)
        W = inputs[1].astype(np.float32)
        R = inputs[2].astype(np.float32)
        Bi = (inputs[3].astype(np.float32)
              if len(inputs) > 3 and inputs[3] is not None else None)
        seq_lens = (inputs[4] if len(inputs) > 4 and inputs[4] is not None
                    else None)
        H = self.hidden_size
        S, Bn, I = X.shape
        nd = W.shape[0]
        h0 = (inputs[5].astype(np.float32)
              if len(inputs) > 5 and inputs[5] is not None
              else np.zeros((nd, Bn, H), np.float32))
        if self.layout and len(inputs) > 5 and inputs[5] is not None:
            h0 = np.swapaxes(h0, 0, 1)
        Y = np.zeros((S, nd, Bn, H), np.float32)
        Yh = np.zeros((nd, Bn, H), np.float32)
        for d in range(nd):
            rev = (self.direction == "reverse") or (d == 1)
            wb = Bi[d][:3 * H] if Bi is not None else np.zeros(3 * H, np.float32)
            rb = Bi[d][3 * H:] if Bi is not None else np.zeros(3 * H, np.float32)
            h = h0[d].copy()
            order = range(S - 1, -1, -1) if rev else range(S)
            for t in order:
                # note: non-linear_before_reset applies rb[2H:] inside
                # the reset product, so pass gh without it there
                if self.linear_before_reset:
                    h_new = self._cell_np(X[t], h, W[d], R[d], wb, rb)
                else:
                    gx = X[t] @ W[d].T + wb
                    gh2 = h @ R[d][:2 * H].T + rb[:2 * H]
                    z = _sig(gx[:, 0:H] + gh2[:, 0:H])
                    r = _sig(gx[:, H:2 * H] + gh2[:, H:2 * H])
                    hh = np.tanh(gx[:, 2 * H:]
                                 + (r * h) @ R[d][2 * H:].T + rb[2 * H:])
                    h_new = (1 - z) * hh + z * h
                if seq_lens is not None:
                    active = (t < np.asarray(seq_lens).astype(np.int64))[:, None]
                    h_new = np.where(active, h_new, h)
                    Y[t, d] = np.where(active, h_new, 0.0)
                else:
                    Y[t, d] = h_new
                h = h_new
            Yh[d] = h
        dt = inputs[0].dtype
        if self.layout:
            return [Y.transpose(2, 0, 1, 3).astype(dt),
                    np.swapaxes(Yh, 0, 1).astype(dt)]
        return [Y.astype(dt), Yh.astype(dt)]

    def infer(self, infos):
        x = infos[0]
        dx = x.dims()
        nd = 2 if self.direction == "bidirectional" else 1
        H = self.hidden_size
        if getattr(self, "layout", 0):
            # batch-first layout transposes S/B in the outputs: RANKED
            n_out = getattr(self, "N_OUTPUTS", 2)
            return ([TensorInfo.ranked(x.dtype, 4)]
                    + [TensorInfo.ranked(x.dtype, 3)] * (n_out - 1))
        if dx is not None:
            from ...scalar_info import ScalarInfo

            S, Bn = dx[0], dx[1]
            return [TensorInfo.shaped(x.dtype, [S, ScalarInfo.of(nd), Bn,
                                                ScalarInfo.of(H)]),
                    TensorInfo.shaped(x.dtype, [ScalarInfo.of(nd), Bn,
                                                ScalarInfo.of(H)])]
        return [TensorInfo.minimal(x.dtype)] * 2


@dataclass
class RnnMilli(MilliOp):
    """ONNX vanilla RNN: h' = act(W x + R h + Wb + Rb)."""

    hidden_size: int = 0
    direction: str = "forward"
    activation: str = "tanh"   # tanh | relu
    layout: int = 0
    KIND = "Rnn"
    N_OUTPUTS = 2

    def _act_np(self, v):
        return np.tanh(v) if self.activation == "tanh" else np.maximum(v, 0)

    def eval(self, inputs):
        X = inputs[0].astype(np.float32)
        if self.layout:
            X = np.swapaxes(X, 0, 1)
        W = inputs[1].astype(np.float32)
        R = inputs[2].astype(np.float32)
        Bi = (inputs[3].astype(np.float32)
              if len(inputs) > 3 and inputs[3] is not None else None)
        seq_lens = (inputs[4] if len(inputs) > 4 and inputs[4] is not None
                    else None)
        H = self.hidden_size
        S, Bn, I = X.shape
        nd = W.shape[0]
        h0 = (inputs[5].astype(np.float32)
              if len(inputs) > 5 and inputs[5] is not None
              else np.zeros((nd, Bn, H), np.float32))
        Y = np.zeros((S, nd, Bn, H), np.float32)
        Yh = np.zeros((nd, Bn, H), np.float32)
        for d in range(nd):
            rev = (self.direction == "reverse") or (d == 1)
            bias = (Bi[d][:H] + Bi[d][H:]) if Bi is not None else np.zeros(H, np.float32)
            h = h0[d].copy()
            order = range(S - 1, -1, -1) if rev else range(S)
            for t in order:
                h_new = self._act_np(X[t] @ W[d].T + h @ R[d].T + bias)
                if seq_lens is not None:
                    active = (t < np.asarray(seq_lens).astype(np.int64))[:, None]
                    h_new = np.where(active, h_new, h)
                    Y[t, d] = np.where(active, h_new, 0.0)
                else:
                    Y[t, d] = h_new
                h = h_new
            Yh[d] = h
        dt = inputs[0].dtype
        if self.layout:
            return [Y.transpose(2, 0, 1, 3).astype(dt),
                    np.swapaxes(Yh, 0, 1).astype(dt)]
        return [Y.astype(dt), Yh.astype(dt)]

    def infer(self, infos):
        x = infos[0]
        dx = x.dims()
        nd = 2 if self.direction == "bidirectional" else 1
        H = self.hidden_size
        if getattr(self, "layout", 0):
            # batch-first layout transposes S/B in the outputs: RANKED
            n_out = getattr(self, "N_OUTPUTS", 2)
            return ([TensorInfo.ranked(x.dtype, 4)]
                    + [TensorInfo.ranked(x.dtype, 3)] * (n_out - 1))
        if dx is not None:
            from ...scalar_info import ScalarInfo

            S, Bn = dx[0], dx[1]
            return [TensorInfo.shaped(x.dtype, [S, ScalarInfo.of(nd), Bn,
                                                ScalarInfo.of(H)]),
                    TensorInfo.shaped(x.dtype, [ScalarInfo.of(nd), Bn,
                                                ScalarInfo.of(H)])]
        return [TensorInfo.minimal(x.dtype)] * 2


def _opt(inputs, i):
    return inputs[i] if len(inputs) > i and inputs[i] is not None else None


def _recurrence(op, inputs, kind: str):
    """The time loop of LSTM, GRU or RNN on the device (module
    docstring); returns the op's outputs in the input's dtype."""
    x = inputs[0]
    X = x.float()
    if op.layout:
        X = X.transpose(0, 1)
    W, R = inputs[1].float(), inputs[2].float()
    Bi, lens = _opt(inputs, 3), _opt(inputs, 4)
    Bi = None if Bi is None else Bi.float()
    H = op.hidden_size
    S, Bn, _ = X.shape
    nd = W.shape[0]
    dev = X.device
    h0 = _opt(inputs, 5)
    h0 = (torch.zeros((nd, Bn, H), device=dev) if h0 is None
          else h0.float())
    c0 = _opt(inputs, 6) if kind == "lstm" else None
    c0 = (None if kind != "lstm" else torch.zeros((nd, Bn, H), device=dev)
          if c0 is None else c0.float())
    if op.layout and kind == "lstm":
        if _opt(inputs, 5) is not None:
            h0 = h0.transpose(0, 1)
        if _opt(inputs, 6) is not None:
            c0 = c0.transpose(0, 1)
    if op.layout and kind == "gru" and _opt(inputs, 5) is not None:
        h0 = h0.transpose(0, 1)
    P = _opt(inputs, 7) if kind == "lstm" else None
    P = None if P is None else P.float()
    G = {"lstm": 4, "gru": 3, "rnn": 1}[kind]
    lens = None if lens is None else lens.long().to(dev)
    ys, hs, cs = [], [], []
    for d in range(nd):
        rev = op.direction == "reverse" or d == 1
        Wd, Rd = W[d], R[d]
        wb = (Bi[d][:G * H] if Bi is not None
              else torch.zeros(G * H, device=dev))
        rb = (Bi[d][G * H:] if Bi is not None
              else torch.zeros(G * H, device=dev))
        h = h0[d]
        c = c0[d] if kind == "lstm" else None
        Y = [None] * S
        for t in (range(S - 1, -1, -1) if rev else range(S)):
            xt = X[t]
            if kind == "lstm":
                g = xt @ Wd.T + h @ Rd.T + (wb + rb)
                pi, po, pf = ((P[d][0:H], P[d][H:2 * H], P[d][2 * H:3 * H])
                              if P is not None else (0.0, 0.0, 0.0))
                i = torch.sigmoid(g[:, 0:H] + pi * c)
                f = torch.sigmoid(g[:, 2 * H:3 * H] + pf * c)
                cc = torch.tanh(g[:, 3 * H:4 * H])
                c2 = f * c + i * cc
                o = torch.sigmoid(g[:, H:2 * H] + po * c2)
                h2 = o * torch.tanh(c2)
            elif kind == "gru":
                gx = xt @ Wd.T + wb
                z = torch.sigmoid(gx[:, 0:H] + h @ Rd[0:H].T + rb[0:H])
                r = torch.sigmoid(gx[:, H:2 * H] + h @ Rd[H:2 * H].T
                                  + rb[H:2 * H])
                if op.linear_before_reset:
                    hh = torch.tanh(gx[:, 2 * H:]
                                    + r * (h @ Rd[2 * H:].T + rb[2 * H:]))
                else:
                    hh = torch.tanh(gx[:, 2 * H:]
                                    + (r * h) @ Rd[2 * H:].T + rb[2 * H:])
                h2 = (1 - z) * hh + z * h
            else:
                v = xt @ Wd.T + h @ Rd.T + (wb + rb)
                h2 = torch.tanh(v) if op.activation == "tanh" \
                    else torch.relu(v)
            if lens is not None:
                active = (t < lens)[:, None]
                h2 = torch.where(active, h2, h)
                if kind == "lstm":
                    c2 = torch.where(active, c2, c)
                Y[t] = torch.where(active, h2, torch.zeros_like(h2))
            else:
                Y[t] = h2
            h = h2
            if kind == "lstm":
                c = c2
        ys.append(torch.stack(Y))
        hs.append(h)
        cs.append(c)
    Y = torch.stack(ys, dim=1)                          # (S, nd, B, H)
    outs = [Y, torch.stack(hs)] + ([torch.stack(cs)] if kind == "lstm"
                                   else [])
    if op.layout:
        outs = [Y.permute(2, 0, 1, 3)] + [o.transpose(0, 1)
                                          for o in outs[1:]]
    return [o.to(x.dtype) for o in outs]


@lowering("Lstm")
def _lower_lstm(op, inputs, static, device):
    return _recurrence(op, inputs, "lstm")


@lowering("Gru")
def _lower_gru(op, inputs, static, device):
    return _recurrence(op, inputs, "gru")


@lowering("Rnn")
def _lower_rnn(op, inputs, static, device):
    return _recurrence(op, inputs, "rnn")
