"""DeepSeek-V2 import recipe: MLA (multi-head latent attention) + MoE.

Reference equivalent: crates/whisper-tensor-import/src/models/llm/
deepseek_v2.rs (539 LoC, MLA/MoE). TPU design notes:

  * MLA cache: the KV cache stores the COMPRESSED latent (B,1,MAX,
    kv_lora_rank) + shared rope key (B,1,MAX,rope_dim) — the memory win
    that makes MLA attractive; keys/values are re-expanded from the
    latent via kv_b_proj each step (non-absorbed decode).
  * rope: HF deepseek reorders interleaved pairs to half layout before a
    NeoX rotation; since only attention scores consume the pe features,
    an interleaved (GPT-J) rotation of both q_pe and k_pe yields
    identical scores — so RotaryEmbedding(interleaved=1) is exact here.
  * MoE: dense (token-dropless) evaluation — every routed expert runs
    and outputs are weighted by the (top-k masked, optionally
    normalized, scaled) router scores. Exact math; the efficient
    gather-based EP kernel is a later optimization. V2 softmax routing;
    V3 sigmoid/bias group routing not yet implemented.

The port's copy of whisper_tensor_tpu/importers/recipes/llm/deepseek.py,
unchanged: the same getter gives the reference's ONNX bytes. Its
attention takes no kernel: the absorbed build's Attention has q and k
576 wide over a 512-wide v, the naive build's 192 over 128, and the
kernels need v as wide as k and a head dim of FLASH_HEAD_DIMS /
DECODE_HEAD_DIMS, so flash_mode and pos_mode send every call of both
builds to the plain path (ROADMAP B7 queues an MLA decode kernel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ....dtype import DType
from ...onnx_builder import OnnxBuilder, WeightStorage
from . import transposed


@dataclass
class DeepseekConfig:
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    vocab_size: int = 102400
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    tie_word_embeddings: bool = False
    # V3 (noaux_tc) routing: sigmoid scores + correction bias chooses
    # experts group-wise; weights come from the raw sigmoid scores.
    scoring_func: str = "softmax"        # softmax (V2) | sigmoid (V3)
    topk_method: str = "greedy"          # greedy (V2) | noaux_tc (V3)
    n_group: int = 1
    topk_group: int = 1

    @staticmethod
    def from_hf(cfg: dict) -> "DeepseekConfig":
        keys = [f.name for f in DeepseekConfig.__dataclass_fields__.values()]  # type: ignore[attr-defined]
        return DeepseekConfig(**{k: cfg[k] for k in keys if k in cfg})

    def is_moe_layer(self, i: int) -> bool:
        return (self.n_routed_experts > 0 and i >= self.first_k_dense_replace
                and i % self.moe_layer_freq == 0)


def build_deepseek_step(weights: Callable[[str], np.ndarray],
                        cfg: DeepseekConfig, max_len: int,
                        dtype: DType = DType.F32,
                        storage: Optional[WeightStorage] = None,
                        absorb: bool = False) -> bytes:
    """absorb=True: absorbed-MLA decode — kv_b_proj is split host-side
    into per-head W_uk/W_uv and folded into the query/output sides, so
    attention runs as MQA directly against the compressed latent cache
    (scores over [q@W_uk ; q_pe] x [latent ; rope-key], values = the
    latent itself). Identical math to the naive expansion (DeepSeek-V2
    paper §MLA), but per-step HBM traffic drops from
    H*(NOPE+VD)*MAX re-expanded floats to (KVL+ROPE)*MAX: the cache is
    read once, not expanded H-fold. The TPU-native decode path."""
    E = cfg.hidden_size
    H = cfg.num_attention_heads
    NOPE, ROPE, VD = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    QD = NOPE + ROPE
    KVL = cfg.kv_lora_rank
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    np_dt = dtype.to_numpy()

    def w(name):
        return np.asarray(weights(name)).astype(np_dt)

    def wT(name):
        return transposed(w(name))

    b = OnnxBuilder("deepseek_step", opset=23, custom_opsets={"wt": 1})
    ids = b.input("input_ids", DType.I64, ["batch", "seq"])
    pos = b.input("pos", DType.I64, [])
    caches = []
    for i in range(L):
        caches.append((
            b.input(f"cache_k_{i}", dtype, ["batch", 1, max_len, KVL]),
            b.input(f"cache_v_{i}", dtype, ["batch", 1, max_len, ROPE])))
    # naming: cache_k_* holds the compressed latent, cache_v_* the rope key

    x = b.gather(b.initializer("embed_tokens", w("model.embed_tokens.weight")), ids)

    seq_shape = b.node("Shape", [ids], start=1, end=2)
    s_scalar = b.node("Squeeze", [seq_shape, b.const_i64([0])])
    zero, one = b.const_i64(0), b.const_i64(1)
    abs_pos = b.add(b.node("Range", [zero, s_scalar, one]),
                    b.node("Cast", [pos], to=7))
    mrange = b.node("Range", [zero, b.const_i64(max_len), one])
    vis = b.node("LessOrEqual",
                 [b.node("Unsqueeze", [mrange, b.const_i64([0])]),
                  b.node("Unsqueeze", [abs_pos, b.const_i64([1])])])
    mask = b.node("Where", [vis, b.const(np.asarray(0.0, dtype=np.float32)),
                            b.const(np.asarray(-1e30, dtype=np.float32))])
    mask = b.node("Unsqueeze", [mask, b.const_i64([0, 1])])
    if dtype is not DType.F32:
        mask = b.cast(mask, dtype)

    # interleaved rope tables over ROPE dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, ROPE, 2, dtype=np.float64) / ROPE))
    ang = np.outer(np.arange(max_len, dtype=np.float64), inv)
    cos = b.initializer("rope_cos", np.cos(ang).astype(np_dt))
    sin = b.initializer("rope_sin", np.sin(ang).astype(np_dt))

    eps = cfg.rms_norm_eps
    cache_outs = []
    for i in range(L):
        p = f"model.layers.{i}."
        h = b.rms_norm(x, b.initializer(f"in_norm_{i}", w(p + "input_layernorm.weight")),
                       epsilon=eps)
        ap = p + "self_attn."
        # -- queries
        if cfg.q_lora_rank:
            qa = b.matmul(h, b.initializer(f"q_a_{i}", wT(ap + "q_a_proj.weight")))
            qa = b.rms_norm(qa, b.initializer(f"q_a_n_{i}", w(ap + "q_a_layernorm.weight")),
                            epsilon=eps)
            q = b.matmul(qa, b.initializer(f"q_b_{i}", wT(ap + "q_b_proj.weight")))
        else:
            q = b.matmul(h, b.initializer(f"q_{i}", wT(ap + "q_proj.weight")))
        q = b.transpose(b.reshape(q, [0, 0, H, QD]), [0, 2, 1, 3])   # (B,H,S,QD)
        q_nope = b.slice_(q, [0], [NOPE], axes=[3])
        q_pe = b.slice_(q, [NOPE], [QD], axes=[3])
        q_pe = b.rotary(q_pe, cos, sin, position_ids=abs_pos, interleaved=True)

        # -- compressed kv + shared rope key
        ckv = b.matmul(h, b.initializer(f"kv_a_{i}", wT(ap + "kv_a_proj_with_mqa.weight")))
        c_lat = b.slice_(ckv, [0], [KVL], axes=[2])
        k_pe = b.slice_(ckv, [KVL], [KVL + ROPE], axes=[2])
        c_lat = b.rms_norm(c_lat, b.initializer(f"kv_a_n_{i}", w(ap + "kv_a_layernorm.weight")),
                           epsilon=eps)
        k_pe = b.node("Unsqueeze", [k_pe, b.const_i64([1])])          # (B,1,S,ROPE)
        k_pe = b.rotary(k_pe, cos, sin, position_ids=abs_pos, interleaved=True)
        c_lat4 = b.node("Unsqueeze", [c_lat, b.const_i64([1])])       # (B,1,S,KVL)

        ck, cv = caches[i]
        n_lat = b.node("CacheWrite", [ck, c_lat4, pos], axis=2, domain="wt",
                       outputs=[f"new_cache_k_{i}"])
        n_pe = b.node("CacheWrite", [cv, k_pe, pos], axis=2, domain="wt",
                      outputs=[f"new_cache_v_{i}"])
        cache_outs.append((n_lat, n_pe))

        if absorb:
            # MQA in latent space: fold W_uk into q, W_uv onto the output
            kv_b = w(ap + "kv_b_proj.weight").reshape(H, NOPE + VD, KVL)
            w_uk = np.ascontiguousarray(kv_b[:, :NOPE, :])   # (H,NOPE,KVL)
            w_uv = np.ascontiguousarray(
                kv_b[:, NOPE:, :].transpose(0, 2, 1))        # (H,KVL,VD)
            q_lat = b.matmul(q_nope, b.initializer(f"w_uk_{i}", w_uk))
            q_cat = b.concat([q_lat, q_pe], axis=3)          # (B,H,S,KVL+ROPE)
            k_cat = b.concat([n_lat, n_pe], axis=3)          # (B,1,MAX,KVL+ROPE)
            att = b.attention(q_cat, k_cat, n_lat, mask=mask,
                              scale=1.0 / float(np.sqrt(QD)))  # (B,H,S,KVL)
            att = b.matmul(att, b.initializer(f"w_uv_{i}", w_uv))
        else:
            # expand all cached latents to per-head keys/values
            lat_all = b.node("Squeeze", [n_lat, b.const_i64([1])])    # (B,MAX,KVL)
            kv = b.matmul(lat_all, b.initializer(f"kv_b_{i}", wT(ap + "kv_b_proj.weight")))
            kv = b.transpose(b.reshape(kv, [0, 0, H, NOPE + VD]), [0, 2, 1, 3])
            k_nope = b.slice_(kv, [0], [NOPE], axes=[3])              # (B,H,MAX,NOPE)
            v_all = b.slice_(kv, [NOPE], [NOPE + VD], axes=[3])       # (B,H,MAX,VD)
            pe_all = b.node("Expand", [n_pe, b.const_i64([1, H, 1, 1])])
            k_all = b.concat([k_nope, pe_all], axis=3)
            q_full = b.concat([q_nope, q_pe], axis=3)
            att = b.attention(q_full, k_all, v_all, mask=mask,
                              scale=1.0 / float(np.sqrt(QD)))
        att = b.reshape(b.transpose(att, [0, 2, 1, 3]), [0, 0, H * VD])
        att = b.matmul(att, b.initializer(f"wo_{i}", wT(ap + "o_proj.weight")))
        x = b.add(x, att)

        # -- MLP / MoE
        h2 = b.rms_norm(x, b.initializer(
            f"post_norm_{i}", w(p + "post_attention_layernorm.weight")), epsilon=eps)

        def swiglu(prefix, xx, tag):
            gate = b.matmul(xx, b.initializer(f"{tag}_g", wT(prefix + "gate_proj.weight")))
            up = b.matmul(xx, b.initializer(f"{tag}_u", wT(prefix + "up_proj.weight")))
            act = b.mul(gate, b.node("Sigmoid", [gate]))
            return b.matmul(b.mul(act, up),
                            b.initializer(f"{tag}_d", wT(prefix + "down_proj.weight")))

        if cfg.is_moe_layer(i):
            logits = b.matmul(h2, b.initializer(
                f"router_{i}", wT(p + "mlp.gate.weight")))
            zero = lambda like: b.node("CastLike", [
                b.const(np.asarray(0.0, dtype=np.float32)), like])
            NE, K = cfg.n_routed_experts, cfg.num_experts_per_tok
            if cfg.scoring_func == "sigmoid":
                # V3 noaux_tc (HF DeepseekV3TopkRouter): sigmoid scores;
                # selection uses scores + e_score_correction_bias,
                # group-wise (sum of top-2 per group -> keep topk_group
                # groups), but the combine WEIGHTS are the raw scores.
                scores = b.node("Sigmoid", [logits])                  # (B,S,NE)
                bias = b.initializer(
                    f"router_bias_{i}",
                    w(p + "mlp.gate.e_score_correction_bias"))
                sfc = b.add(scores, bias)
                G = cfg.n_group
                gview = b.reshape(sfc, [0, 0, G, NE // G])
                g2, _ = b.node("TopK", [gview, b.const_i64([2])],
                               n_outputs=2, axis=-1)
                gscore = b.node("ReduceSum", [g2, b.const_i64([-1])],
                                keepdims=0)                           # (B,S,G)
                gtop, _ = b.node("TopK", [gscore,
                                          b.const_i64([cfg.topk_group])],
                                 n_outputs=2, axis=-1)
                gkth = b.slice_(gtop, [cfg.topk_group - 1],
                                [cfg.topk_group], axes=[2])
                gmask = b.node("GreaterOrEqual", [gscore, gkth])      # (B,S,G)
                gmask = b.node("Expand", [
                    b.node("Unsqueeze", [gmask, b.const_i64([3])]),
                    b.const_i64([1, 1, G, NE // G])])
                gmask = b.reshape(gmask, [0, 0, NE])
                masked = b.node("Where", [gmask, sfc, zero(sfc)])
                topv, _ = b.node("TopK", [masked, b.const_i64([K])],
                                 n_outputs=2, axis=-1)
                kth = b.slice_(topv, [K - 1], [K], axes=[2])
                sel = b.node("And", [b.node("GreaterOrEqual",
                                            [masked, kth]), gmask])
                wts = b.node("Where", [sel, scores, zero(scores)])
                if cfg.norm_topk_prob:
                    den = b.node("ReduceSum", [wts, b.const_i64([-1])],
                                 keepdims=1)
                    den = b.add(den, b.node("CastLike", [
                        b.const(np.asarray(1e-20, dtype=np.float32)), den]))
                    wts = b.node("Div", [wts, den])
            else:
                # V2: softmax scores, plain top-k mask, optional prob norm
                scores = b.softmax(logits, axis=-1)                   # (B,S,NE)
                topv, _ = b.node("TopK", [scores, b.const_i64([K])],
                                 n_outputs=2, axis=-1)
                kth = b.slice_(topv, [K - 1], [K], axes=[2])
                sel = b.node("GreaterOrEqual", [scores, kth])
                wts = b.node("Where", [sel, scores, zero(scores)])
                if cfg.norm_topk_prob:
                    den = b.node("ReduceSum", [wts, b.const_i64([-1])],
                                 keepdims=1)
                    wts = b.node("Div", [wts, den])
            if cfg.routed_scaling_factor != 1.0:
                sf = b.const(np.asarray(cfg.routed_scaling_factor, dtype=np.float32))
                wts = b.mul(wts, b.node("CastLike", [sf, wts]))
            acc = None
            for j in range(cfg.n_routed_experts):
                e_out = swiglu(p + f"mlp.experts.{j}.", h2, f"exp_{i}_{j}")
                wj = b.slice_(wts, [j], [j + 1], axes=[2])            # (B,S,1)
                term = b.mul(e_out, wj)
                acc = term if acc is None else b.add(acc, term)
            if cfg.n_shared_experts:
                acc = b.add(acc, swiglu(p + "mlp.shared_experts.", h2,
                                        f"shexp_{i}"))
            mlp = acc
        else:
            mlp = swiglu(p + "mlp.", h2, f"mlp_{i}")
        x = b.add(x, mlp)

    xf = b.rms_norm(x, b.initializer("final_norm", w("model.norm.weight")),
                    epsilon=eps)
    lm = (transposed(w("model.embed_tokens.weight"))
          if cfg.tie_word_embeddings else wT("lm_head.weight"))
    b.node("MatMul", [xf, b.initializer("lm_head", lm)], outputs=["logits"])
    b.output("logits", dtype, ["batch", "seq", V])
    for i, (nk, nv) in enumerate(cache_outs):
        b.output(nk, dtype, ["batch", 1, max_len, KVL])
        b.output(nv, dtype, ["batch", 1, max_len, ROPE])
    return b.build(storage or WeightStorage.embed())
