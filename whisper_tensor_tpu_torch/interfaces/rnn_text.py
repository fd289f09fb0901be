"""RNN (constant-state) text interface for RWKV-family step models, on
PyTorch.

Counterpart of whisper_tensor_tpu/interfaces/rnn_text.py. The step
graph has named state I/O pairs (<name> in, new_<name> out). The
reference compiles prefill and greedy decoding into lax.scan programs
over the traced step; here both are loops over the step graph on the
device: the states and the fed-back tokens stay there (the greedy argmax
runs on the card), and only the tokens are read back, once, at the end.
The matmuls that share an input fuse as the reference fuses them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..backends.torch_exec.compiler import GraphExecutor
from ..device import resolve_device
from ..dtype import to_host, to_torch
from ..milli.transforms import apply_matmul_fusion
from ..model import Model
from ..weights import carry_weights


class RnnTextInterface:
    def __init__(self, model: Model, tokenizer=None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.tokenizer = tokenizer
        milli, weight_inputs = model.graph.to_milli()
        self.milli = milli
        # the r/k/v/g projections of one x fuse: exact concatenation
        self._fused, self._dense_np = apply_matmul_fusion(
            milli, weight_inputs, model.graph.store)
        self.weight_names = [n for n in milli.inputs
                             if n in weight_inputs or n in self._fused]
        self.state_names = [n for n in milli.inputs
                            if n not in self.weight_names and n != "token"]
        for n in self.state_names:
            assert f"new_{n}" in milli.outputs, n
        self._exec = GraphExecutor(milli, self.device)
        self._weights_dev: Optional[Dict[str, torch.Tensor]] = None

    def _declared(self, n: str):
        g = self.model.graph
        name = self._fused[n][0][0] if n in self._fused else n
        return g.tensors[g.by_name[name]].info.dtype

    def _weights(self) -> Dict[str, torch.Tensor]:
        if self._weights_dev is None:
            self._weights_dev = carry_weights(
                {n: self._dense_np(n) for n in self.weight_names},
                {n: self._declared(n) for n in self.weight_names},
                self.device)
        return self._weights_dev

    def fresh_state(self, batch: int) -> Dict[str, torch.Tensor]:
        out = {}
        for n in self.state_names:
            info = self.model.graph.tensors[self.model.graph.by_name[n]].info
            dims = [batch if not d.is_known else int(d.value())
                    for d in info.dims()]
            out[n] = torch.zeros(tuple(dims), dtype=to_torch(info.dtype),
                                 device=self.device)
        return out

    def step(self, tok: torch.Tensor, states: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(B,) int64 tokens on the device -> (B, V) logits, new states."""
        feeds = {"token": tok, **states, **self._weights()}
        outs = self._exec(feeds)
        return outs["logits"], {n: outs[f"new_{n}"] for n in self.state_names}

    def _feed(self, tokens, states=None):
        tokens = np.asarray(tokens, dtype=np.int64)
        if tokens.ndim == 1:
            tokens = tokens[None]
        B, L = tokens.shape
        states = states if states is not None else self.fresh_state(B)
        seq = torch.from_numpy(tokens).to(self.device)
        logits = None
        for t in range(L):
            logits, states = self.step(seq[:, t], states)
        return logits, states

    # ------------------------------------------------------------------
    def feed_tokens(self, tokens, states=None):
        """Prefill: run tokens (B, L) through the recurrence. Returns
        (the last step's logits (B, V) on the host, the states on the
        device)."""
        logits, states = self._feed(tokens, states)
        return to_host(logits), states

    def generate_tokens(self, prompt, n_new: int) -> np.ndarray:
        """Greedy: (B, L) prompt -> (B, n_new) tokens, each fed back on
        the device."""
        logits, states = self._feed(prompt)
        toks = [torch.argmax(logits, dim=-1)]
        for _ in range(1, n_new):
            logits, states = self.step(toks[-1], states)
            toks.append(torch.argmax(logits, dim=-1))
        return torch.stack(toks[:n_new], dim=1).cpu().numpy()

    def run_string_in_string_out(self, text: str, n_new: int = 32) -> str:
        ids = np.asarray(self.tokenizer.encode(text), dtype=np.int64)[None]
        toks = self.generate_tokens(ids, n_new)[0]
        return self.tokenizer.decode([int(t) for t in toks])
