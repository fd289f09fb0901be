"""Llama-family import recipe (llama3 / mistral / qwen2 / qwen3-dense).

Reference equivalents: crates/whisper-tensor-import/src/models/llm/
{llama3,qwen2}.rs. Same TPU design as the GPT-2 recipe: one unified
step graph with fixed-shape KV caches + scalar position; RMSNorm,
rotary embeddings (NeoX halves), GQA fused attention, SwiGLU MLP.

The port's copy of whisper_tensor_tpu/importers/recipes/llm/llama.py,
with the training graph
(`build_llama_train`, :276-356). A weight getter may return an
origin-bearing LazyWeight (SafetensorsStore.lazy) in the graph's type:
the step graph then keeps it as a reference to the checkpoint (under
WeightStorage.origin_reference() the ONNX carries no payload), and a
matmul weight stays in its (out, in) layout, transposed by a Transpose
node, since a byte span cannot describe a transposed tensor. `storage`
and the `weight_map` out-parameter (:88-125, :280-304) are the
reference's: the packed GGUF loader builds the graph structure-only
into a sink and binds the matmul weights that weight_map names to
packed sources.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ....dtype import DType
from ...onnx_builder import LazyWeight, OnnxBuilder, WeightStorage
from . import transposed


@dataclass
class LlamaConfig:
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    hidden_size: int = 4096
    intermediate_size: int = 14336
    vocab_size: int = 128256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False       # qwen2: True
    head_dim: Optional[int] = None
    model_type: str = "llama"
    # Mixtral sparse MoE (block_sparse_moe): 0 = dense MLP
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    # qwen3: per-head RMS norm on q/k before rope; qwen3_moe experts
    qk_norm: bool = False
    moe_style: str = "mixtral"         # weight naming: mixtral | qwen3
    norm_topk_prob: bool = True

    @staticmethod
    def from_hf(cfg: dict) -> "LlamaConfig":
        return LlamaConfig(
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads",
                                        cfg["num_attention_heads"]),
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            vocab_size=cfg["vocab_size"],
            max_position_embeddings=cfg.get("max_position_embeddings", 8192),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            rope_theta=cfg.get("rope_theta", 10000.0),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            attention_bias=cfg.get("attention_bias",
                                   cfg.get("model_type") == "qwen2"),
            head_dim=cfg.get("head_dim"),
            model_type=cfg.get("model_type", "llama"),
            num_local_experts=cfg.get("num_local_experts",
                                      cfg.get("num_experts", 0)),
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
            qk_norm=cfg.get("model_type", "") in ("qwen3", "qwen3_moe"),
            moe_style=("qwen3" if cfg.get("model_type", "") == "qwen3_moe"
                       else "mixtral"),
            norm_topk_prob=cfg.get("norm_topk_prob", True),
        )

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


def rope_tables(cfg: LlamaConfig, max_len: int):
    """cos/sin tables (max_len, head_dim/2), NeoX-style halves."""
    hd = cfg.hd
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    pos = np.arange(max_len, dtype=np.float64)
    ang = np.outer(pos, inv)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def build_llama_step(weights: Callable[[str], np.ndarray], cfg: LlamaConfig,
                     max_len: int, dtype: DType = DType.F32,
                     storage: Optional[WeightStorage] = None,
                     pos_per_row: bool = False,
                     weight_map: Optional[dict] = None,
                     logits_last_only: bool = False) -> bytes:
    """HF llama state-dict names; HF Linear weights are (out, in) and are
    transposed once at import into matmul-RHS layout.

    pos_per_row=True gives `pos` shape (batch,) — ragged continuous
    batching (see recipes/llm/gpt2.py and server/batching.py).

    weight_map (optional out-param): records {initializer_name:
    hf_name} for every 2-D matmul-RHS weight — the packed-GGUF loader
    uses it to bind those initializers to lazily-loaded packed tensors
    instead of dense payloads.

    logits_last_only=True slices the hidden state to the LAST position
    before the lm_head, so logits are (B, 1, V) instead of (B, S, V):
    at long-context prefill the full logits dominate device memory
    (16k x 128,256 bf16 = 4.2 GB a row) and generation reads only the
    last position. The interface reads such a graph only where the
    prompt fills its bucket (interfaces/text.py, `logits_last_only`)."""
    E = cfg.hidden_size
    Hq = cfg.num_attention_heads
    Hkv = cfg.num_key_value_heads
    D = cfg.hd
    L = cfg.num_hidden_layers
    V = cfg.vocab_size
    I = cfg.intermediate_size
    np_dt = dtype.to_numpy()

    def w(name: str):
        v = weights(name)
        if isinstance(v, LazyWeight):
            if v.origin and v.dtype == dtype:
                return v        # stays a reference to the checkpoint
            v = v.load()
        return np.asarray(v).astype(np_dt)

    def rhs(init_name: str, hf_name: str) -> str:
        # matmul-RHS weight: the transposed payload, or a referenced
        # (out, in) checkpoint tensor transposed in the graph
        v = w(hf_name)
        if isinstance(v, LazyWeight):
            return b.node("Transpose", [b.initializer(init_name + "_hf", v)],
                          outputs=[init_name], perm=[1, 0])
        return b.initializer(init_name, transposed(v))

    def lin(init_name: str, hf_name: str) -> str:
        # matmul-RHS weight + weight_map entry
        if weight_map is not None:
            weight_map[init_name] = hf_name
        return rhs(init_name, hf_name)

    b = OnnxBuilder(f"{cfg.model_type}_step", opset=23, custom_opsets={"wt": 1})
    ids = b.input("input_ids", DType.I64, ["batch", "seq"])
    pos = b.input("pos", DType.I64, ["batch"] if pos_per_row else [])
    cache_ins = []
    for i in range(L):
        cache_ins.append((
            b.input(f"cache_k_{i}", dtype, ["batch", Hkv, max_len, D]),
            b.input(f"cache_v_{i}", dtype, ["batch", Hkv, max_len, D])))

    embed = b.initializer("embed_tokens", w("model.embed_tokens.weight"))
    x = b.gather(embed, ids)

    # positions + masks
    seq_shape = b.node("Shape", [ids], start=1, end=2)
    s_scalar = b.node("Squeeze", [seq_shape, b.const_i64([0])])
    zero, one = b.const_i64(0), b.const_i64(1)
    rel = b.node("Range", [zero, s_scalar, one])
    if pos_per_row:
        abs_pos = b.add(rel, b.node("Unsqueeze", [pos, b.const_i64([1])]))
    else:
        abs_pos = b.add(rel, b.node("Cast", [pos], to=7))           # (S,)
    if pos_per_row:
        # rank-1 position mask (wt Attention extension): row b sees
        # keys j <= pos[b] + s — semantically identical to the dense
        # Where mask this used to build, but lets the TPU backend
        # dispatch the ragged flash-decode kernel that reads only each
        # row's live KV prefix (backends/pallas/decode_attention.py)
        mask = pos
    else:
        # rank-0 position mask (wt Attention extension, same rule as
        # the rank-1 form: key j visible to query row s iff
        # j <= pos + s). The dense Where mask this replaces cost a
        # (S, max_len) tensor that, streamed per q-tile, OOM'd scoped
        # VMEM in the flash kernel at S=8k; the rank-0 form lets the
        # TPU backend enforce the bound in-register (pos-bound flash
        # kernel) and the XLA/oracle paths synthesize the same dense
        # mask internally.
        mask = pos

    cos_t, sin_t = rope_tables(cfg, max_len)
    cos = b.initializer("rope_cos", cos_t.astype(np_dt))
    sin = b.initializer("rope_sin", sin_t.astype(np_dt))

    eps = cfg.rms_norm_eps
    cache_outs = []
    for i in range(L):
        p = f"model.layers.{i}."
        h = b.rms_norm(x, b.initializer(f"in_norm_{i}", w(p + "input_layernorm.weight")),
                       epsilon=eps)
        q = b.matmul(h, lin(f"wq_{i}", p + "self_attn.q_proj.weight"))
        k = b.matmul(h, lin(f"wk_{i}", p + "self_attn.k_proj.weight"))
        v = b.matmul(h, lin(f"wv_{i}", p + "self_attn.v_proj.weight"))
        if cfg.attention_bias:
            q = b.add(q, b.initializer(f"bq_{i}", w(p + "self_attn.q_proj.bias")))
            k = b.add(k, b.initializer(f"bk_{i}", w(p + "self_attn.k_proj.bias")))
            v = b.add(v, b.initializer(f"bv_{i}", w(p + "self_attn.v_proj.bias")))

        def heads(tns, nh):
            return b.transpose(b.reshape(tns, [0, 0, nh, D]), [0, 2, 1, 3])

        qh, kh = heads(q, Hq), heads(k, Hkv)
        if cfg.qk_norm:
            # qwen3: per-head RMS norm on q/k BEFORE rope
            qh = b.rms_norm(qh, b.initializer(
                f"qn_{i}", w(p + "self_attn.q_norm.weight")), epsilon=eps)
            kh = b.rms_norm(kh, b.initializer(
                f"kn_{i}", w(p + "self_attn.k_norm.weight")), epsilon=eps)
        qh = b.rotary(qh, cos, sin, position_ids=abs_pos)
        kh = b.rotary(kh, cos, sin, position_ids=abs_pos)
        vh = heads(v, Hkv)
        ck, cv = cache_ins[i]
        nk = b.node("CacheWrite", [ck, kh, pos], axis=2, domain="wt",
                    outputs=[f"new_cache_k_{i}"])
        nv = b.node("CacheWrite", [cv, vh, pos], axis=2, domain="wt",
                    outputs=[f"new_cache_v_{i}"])
        cache_outs.append((nk, nv))
        att = b.attention(qh, nk, nv, mask=mask, scale=1.0 / float(np.sqrt(D)))
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, Hq * D])
        att = b.matmul(att, lin(f"wo_{i}", p + "self_attn.o_proj.weight"))
        x = b.add(x, att)

        h2 = b.rms_norm(x, b.initializer(
            f"post_norm_{i}", w(p + "post_attention_layernorm.weight")), epsilon=eps)
        if cfg.num_local_experts:
            # Mixtral block_sparse_moe / Qwen3-MoE mlp (same math: softmax
            # over ALL experts, top-k mask, renormalize over the selected
            # set when norm_topk_prob); dense token-dropless evaluation.
            K = cfg.num_experts_per_tok
            moe_p = ("mlp." if cfg.moe_style == "qwen3"
                     else "block_sparse_moe.")
            logits = b.matmul(h2, rhs(
                f"router_{i}", p + moe_p + "gate.weight"))
            scores = b.softmax(logits, axis=-1)
            topv, _ = b.node("TopK", [scores, b.const_i64([K])],
                             n_outputs=2, axis=-1)
            kth = b.slice_(topv, [K - 1], [K], axes=[2])
            sel = b.node("GreaterOrEqual", [scores, kth])
            zero = b.node("CastLike", [b.const(np.asarray(0.0, np.float32)),
                                       scores])
            wts = b.node("Where", [sel, scores, zero])
            if cfg.norm_topk_prob:
                den = b.node("ReduceSum", [wts, b.const_i64([-1])],
                             keepdims=1)
                wts = b.node("Div", [wts, den])
            names = (("gate_proj", "up_proj", "down_proj")
                     if cfg.moe_style == "qwen3" else ("w1", "w3", "w2"))
            acc = None
            for j in range(cfg.num_local_experts):
                ep = p + moe_p + f"experts.{j}."
                eg = b.matmul(h2, rhs(f"e{i}_{j}_w1",
                                      ep + names[0] + ".weight"))
                eu = b.matmul(h2, rhs(f"e{i}_{j}_w3",
                                      ep + names[1] + ".weight"))
                eact = b.mul(b.mul(eg, b.node("Sigmoid", [eg])), eu)
                eo = b.matmul(eact, rhs(f"e{i}_{j}_w2",
                                        ep + names[2] + ".weight"))
                term = b.mul(eo, b.slice_(wts, [j], [j + 1], axes=[2]))
                acc = term if acc is None else b.add(acc, term)
            mlp = acc
        else:
            gate = b.matmul(h2, lin(f"w_gate_{i}", p + "mlp.gate_proj.weight"))
            up = b.matmul(h2, lin(f"w_up_{i}", p + "mlp.up_proj.weight"))
            silu = b.mul(gate, b.node("Sigmoid", [gate]))
            mlp = b.matmul(b.mul(silu, up),
                           lin(f"w_down_{i}", p + "mlp.down_proj.weight"))
        x = b.add(x, mlp)

    xf = b.rms_norm(x, b.initializer("final_norm", w("model.norm.weight")),
                    epsilon=eps)
    if logits_last_only:
        xf = b.node("Slice", [
            xf, b.const(np.asarray([-1], np.int64)),
            b.const(np.asarray([np.iinfo(np.int64).max], np.int64)),
            b.const(np.asarray([1], np.int64))])
    if cfg.tie_word_embeddings:
        lm = rhs("lm_head", "model.embed_tokens.weight")
    else:
        lm = lin("lm_head", "lm_head.weight")
    b.node("MatMul", [xf, lm], outputs=["logits"])
    b.output("logits", dtype,
             ["batch", 1 if logits_last_only else "seq", V])
    for i, (nk, nv) in enumerate(cache_outs):
        b.output(nk, dtype, ["batch", Hkv, max_len, D])
        b.output(nv, dtype, ["batch", Hkv, max_len, D])
    return b.build(storage or WeightStorage.embed())


def hf_weight_getter(model) -> Callable[[str], np.ndarray]:
    sd = model.state_dict()

    def get(name: str) -> np.ndarray:
        if name not in sd and name == "lm_head.weight":
            return sd["model.embed_tokens.weight"].detach().cpu().float().numpy()
        return sd[name].detach().cpu().float().numpy()

    return get


def build_llama_train(weights: Callable[[str], np.ndarray],
                      cfg: LlamaConfig, max_len: int,
                      dtype: DType = DType.F32,
                      storage: Optional[WeightStorage] = None,
                      weight_map: Optional[dict] = None) -> bytes:
    """Training-mode llama graph: input_ids (B,S) -> logits (B,S,V).

    No KV caches; fused causal attention; rope applied at absolute
    positions 0..S-1. Weights stay runtime inputs so jax.grad (and the
    LoRA/frozen-int8 trainer path) differentiates through them —
    mirrors build_gpt2_train. Dense mlp only (training MoE routes
    through the parallel.moe trainer instead)."""
    E, Hq, Hkv, D = cfg.hidden_size, cfg.num_attention_heads, \
        cfg.num_key_value_heads, cfg.hd
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    np_dt = dtype.to_numpy()

    def w(name: str) -> np.ndarray:
        return np.asarray(weights(name)).astype(np_dt)

    def wT(name: str) -> np.ndarray:
        return transposed(w(name))

    b = OnnxBuilder(f"{cfg.model_type}_train", opset=23,
                    custom_opsets={"wt": 1})

    def lin(init_name: str, hf_name: str) -> str:
        if weight_map is not None:
            weight_map[init_name] = hf_name
        return b.initializer(init_name, wT(hf_name))

    ids = b.input("input_ids", DType.I64, ["batch", "seq"])
    embed = b.initializer("embed_tokens", w("model.embed_tokens.weight"))
    x = b.gather(embed, ids)
    cos_t, sin_t = rope_tables(cfg, max_len)
    cos = b.initializer("rope_cos", cos_t.astype(np_dt))
    sin = b.initializer("rope_sin", sin_t.astype(np_dt))
    eps = cfg.rms_norm_eps
    for i in range(L):
        p = f"model.layers.{i}."
        h = b.rms_norm(x, b.initializer(
            f"in_norm_{i}", w(p + "input_layernorm.weight")), epsilon=eps)
        q = b.matmul(h, lin(f"wq_{i}", p + "self_attn.q_proj.weight"))
        k = b.matmul(h, lin(f"wk_{i}", p + "self_attn.k_proj.weight"))
        v = b.matmul(h, lin(f"wv_{i}", p + "self_attn.v_proj.weight"))

        def heads(tns, nh):
            return b.transpose(b.reshape(tns, [0, 0, nh, D]), [0, 2, 1, 3])

        qh, kh, vh = heads(q, Hq), heads(k, Hkv), heads(v, Hkv)
        qh = b.rotary(qh, cos, sin)
        kh = b.rotary(kh, cos, sin)
        att = b.attention(qh, kh, vh, scale=1.0 / float(np.sqrt(D)),
                          is_causal=True)
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, Hq * D])
        att = b.matmul(att, lin(f"wo_{i}", p + "self_attn.o_proj.weight"))
        x = b.add(x, att)
        h2 = b.rms_norm(x, b.initializer(
            f"post_norm_{i}", w(p + "post_attention_layernorm.weight")),
            epsilon=eps)
        gate = b.matmul(h2, lin(f"w_gate_{i}", p + "mlp.gate_proj.weight"))
        up = b.matmul(h2, lin(f"w_up_{i}", p + "mlp.up_proj.weight"))
        silu = b.mul(gate, b.node("Sigmoid", [gate]))
        mlp = b.matmul(b.mul(silu, up),
                       lin(f"w_down_{i}", p + "mlp.down_proj.weight"))
        x = b.add(x, mlp)
    xf = b.rms_norm(x, b.initializer("final_norm", w("model.norm.weight")),
                    epsilon=eps)
    if cfg.tie_word_embeddings:
        lm = b.initializer("lm_head", transposed(
            w("model.embed_tokens.weight")))
    else:
        lm = lin("lm_head", "lm_head.weight")
    b.node("MatMul", [xf, lm], outputs=["logits"])
    b.output("logits", dtype, ["batch", "seq", V])
    return b.build(storage or WeightStorage.embed())
