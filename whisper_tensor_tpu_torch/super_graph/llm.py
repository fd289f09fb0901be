"""LLM decode SuperGraph builder.

Reference equivalent: the shared rnn_supergraph builder all LLM loaders
use (crates/whisper-tensor-import/src/loaders/shared/rnn_supergraph.rs:
29-37): tokenize -> cache-resume -> per-token Scan over ModelExecution
-> cache-write -> decode.

TPU note: this graph is the *introspectable* path — every step's
tensors stream through observers. The throughput path is
interfaces.text.TextInferenceInterface, which compiles the same step
model into one lax.scan program. Both drive identical step graphs.

The port's copy of whisper_tensor_tpu/super_graph/llm.py (:30-155). The
KV caches are made in the type the step graph declares for them
(`cache_dtype` serves a graph that declares none; the reference makes
`cache_dtype`, whose f32 default its interpreter refuses on a bf16 step
graph). In torch mode they are made on the device, stay there between
steps, and are written in place
by the step graph's cache writes; each step's greedy token is taken on
the device (`torch.argmax` takes the first maximum, as numpy does) and
only the token crosses to the host. The graph's JSON is the reference's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dtype import DType, to_torch
from .graph import ExecutionContext, SuperGraph
from .image import ConstNode   # (its iteration count; registers the kind)
from .links import LinkKind
from .nodes import (ModelExecutionNode, RNNCacheReadNode, RNNCacheWriteNode,
                    ScanNode, SuperNode, TokenizerDecodeNode,
                    TokenizerEncodeNode, host_value, register_node)


def _greedy(logits, row: int):
    """(next ids as the step graph takes them, host tokens (B,) i64):
    the argmax of logits[:, row, :], on the device for a tensor."""
    if isinstance(logits, torch.Tensor):
        nxt = torch.argmax(logits[:, row, :], dim=-1)
        return nxt, nxt.cpu().numpy()
    nxt = np.argmax(np.asarray(logits)[:, row, :], axis=-1).astype(np.int64)
    return nxt, nxt


def _zero_cache(ctx, model, name: str, shape, cache_dtype: str):
    """A zero cache in the type the graph declares for it (`cache_dtype`
    where it declares none): on the device in torch mode, numpy in the
    oracle. (The reference makes `cache_dtype`, f32 by default, so its
    oracle refuses a bf16 step graph's cache writes.)"""
    g = model.graph
    dt = g.tensors[g.by_name[name]].dtype if name in g.by_name else None
    if dt is None:
        dt = DType.from_numpy(np.dtype(cache_dtype))
    if ctx.backend_mode != "torch":
        return np.zeros(shape, dtype=dt.to_numpy())
    return torch.zeros(shape, dtype=to_torch(dt), device=ctx.device)


@register_node
class LLMDecodeStepNode(SuperNode):
    """One greedy decode step over a unified step model.

    in: 'tensors' (state tensor map: caches + cur_ids + pos),
    out: 'tensors' (updated state), 'token' (chosen token (B,))
    params: model_ref.
    """

    def execute(self, ctx, ins):
        state = dict(ins["tensors"])
        model = ctx.models[self.params["model_ref"]]
        feeds = {k: v for k, v in state.items() if not k.startswith("_")}
        out = ctx.run_model(model, feeds)
        nxt, token = _greedy(out["logits"], -1)
        new_state = dict(state)
        for k, v in out.items():
            if k.startswith("new_cache_"):
                new_state[k.replace("new_", "")] = v
        new_state["input_ids"] = nxt[:, None]
        new_state["pos"] = np.asarray(
            int(host_value(state["pos"])) + state["input_ids"].shape[1],
            dtype=np.int64)
        return {"tensors": new_state, "token": token}


@register_node
class LLMPrefillNode(SuperNode):
    """Prefill the KV caches from the prompt tokens; emit first token.

    params: model_ref, n_layers, n_kv_heads, max_len, head_dim,
            cache_dtype (numpy dtype name) — all serialized so the graph
            deserializes in a fresh process (ADVICE r2: no closure refs).
    """

    def execute(self, ctx, ins):
        p = self.params
        model = ctx.models[p["model_ref"]]
        toks = np.asarray(host_value(ins["tokens"]),
                          dtype=np.int64).reshape(1, -1)
        L = toks.shape[1]
        state = {"input_ids": toks, "pos": np.asarray(0, dtype=np.int64)}
        shape = (1, int(p["n_kv_heads"]), int(p["max_len"]),
                 int(p["head_dim"]))
        for i in range(int(p["n_layers"])):
            for kv in ("k", "v"):
                state[f"cache_{kv}_{i}"] = _zero_cache(
                    ctx, model, f"cache_{kv}_{i}", shape, p["cache_dtype"])
        out = ctx.run_model(model, state)
        nxt, first = _greedy(out["logits"], L - 1)
        new_state = {k.replace("new_", ""): v for k, v in out.items()
                     if k.startswith("new_cache_")}
        new_state["input_ids"] = nxt[:, None]
        new_state["pos"] = np.asarray(L, dtype=np.int64)
        return {"tensors": new_state, "token": first}


@register_node
class JoinTokensNode(SuperNode):
    """Prepend the prefill's first token to the scanned token column."""

    def execute(self, ctx, ins):
        first = np.asarray(host_value(ins["first"])).reshape(1, -1)  # (1,B)
        rest = np.asarray(host_value(ins["rest"]))                   # (n-1,B)
        return {"tokens": np.concatenate([first, rest], axis=0)[:, 0]}


def build_llm_supergraph(model_name: str, tokenizer_source: str,
                         n_layers: int, n_kv_heads: int, max_len: int,
                         head_dim: int, n_new: int,
                         cache_dtype=np.float32) -> SuperGraph:
    """text -> tokens -> prefill -> scan(decode) -> text."""
    g = SuperGraph(f"llm:{model_name}")
    text_in = g.mark_input("text", g.link(LinkKind.STRING, "text"))
    tok_l = g.link(LinkKind.TOKENIZER, "tokenizer")
    tokens_l = g.link(LinkKind.TENSOR, "prompt_tokens")
    state0_l = g.link(LinkKind.TENSOR_MAP, "prefill_state")
    first_tok_l = g.link(LinkKind.TENSOR, "first_token")
    scan_state_l = g.link(LinkKind.TENSOR_MAP, "final_state")
    toks_out_l = g.link(LinkKind.TENSOR, "generated_tokens")
    text_out_l = g.link(LinkKind.STRING, "generated_text")

    from .nodes import TokenizerLoadNode

    g.add(TokenizerLoadNode(outputs={"tokenizer": tok_l},
                            source=tokenizer_source))
    g.add(TokenizerEncodeNode(inputs={"tokenizer": tok_l, "text": text_in},
                              outputs={"tokens": tokens_l}))

    g.add(LLMPrefillNode(inputs={"tokens": tokens_l},
                         outputs={"tensors": state0_l, "token": first_tok_l},
                         model_ref=model_name, n_layers=n_layers,
                         n_kv_heads=n_kv_heads, max_len=max_len,
                         head_dim=head_dim,
                         cache_dtype=np.dtype(cache_dtype).name))

    # decode loop as a Scan over the step node
    body = SuperGraph("decode_body")
    b_state_in = body.mark_input("state", body.link(LinkKind.TENSOR_MAP))
    b_state_out = body.link(LinkKind.TENSOR_MAP)
    b_tok = body.link(LinkKind.TENSOR)
    body.add(LLMDecodeStepNode(inputs={"tensors": b_state_in},
                               outputs={"tensors": b_state_out, "token": b_tok},
                               model_ref=model_name))
    body.mark_output("state_out", b_state_out)
    body.mark_output("token", b_tok)

    n_iters_l = g.link(LinkKind.TENSOR, "n_iters")
    g.add(ConstNode(outputs={"value": n_iters_l}, value=n_new - 1))
    scan = ScanNode(inputs={"state": state0_l, "n_iters": n_iters_l},
                    outputs={"final_state": scan_state_l,
                             "tokens": g.link(LinkKind.TENSOR, "scan_tokens")},
                    state=[("state", "state", "state_out")],
                    scan_inputs=[], scan_outputs=[("token", "tokens", 0)],
                    body=None)
    scan.body = body
    scan_tokens_l = scan.outputs["tokens"]
    g.add(scan)

    g.add(JoinTokensNode(inputs={"first": first_tok_l, "rest": scan_tokens_l},
                         outputs={"tokens": toks_out_l}))
    g.add(TokenizerDecodeNode(inputs={"tokenizer": tok_l, "tokens": toks_out_l},
                              outputs={"text": text_out_l}))
    g.mark_output("text", text_out_l)
    g.mark_output("tokens", toks_out_l)
    g.validate()
    return g
