"""Text inference on PyTorch: tokens in, logits and generated tokens out.

Counterpart of whisper_tensor_tpu/interfaces/text.py:249-1236, the part
the server's direct text path calls. The reference compiles prefill and
the whole decode loop into one XLA program with donated caches; here
the step graph runs eagerly through GraphExecutor:
  * prefill at the prompt's bucket length, then one step per token;
  * the KV caches are device tensors this interface allocates, written
    in place by the graph's cache writes, a layer's K and V in one
    KVWrite node (milli/transforms.py:pair_cache_writes);
  * positions, tokens and sampling state stay on the device, so the
    loop never waits for the device until the tokens are read back.

Ported: dense and `quantize="int8"` weights; packed weights kept
packed on the device through the packed_matmul kernel, from a GGUF
file's or a GPTQ/AWQ checkpoint's packed sources (`quantize="packed"`,
or automatically when the loader recorded packed sources) and
host-quantized from any dense checkpoint (`quantize="q4_0" | "q8_0" |
"q5_0" | "q4_k" | "q6_k"`, reference :341-390; weights that are not 2-D
or whose K is not a multiple of the block stay dense); q/k/v and
gate/up matmul fusion (on unless adapters are installed, which de-fuse
the graph as the reference does), prompt buckets, greedy
decoding, SamplingParams on a seeded torch.Generator, logit_bias, and
the per-row sampling the ContinuousBatcher runs (`_pick_token_rows`).
SamplingParams, the prompt buckets and the per-row sampling arrays are
the port's copy of the reference's (:27-56, :109-142, :224-233); the
default buckets go on past the reference's 1024 to 8192, so a long
prompt prefills at its own bucket instead of failing.

Also ported (reference :195-214, :868-978, :1236-1441):
  * DFA-constrained decoding (`compile_constraint`, `generate_tokens(
    constraint=)`, `run_string_in_string_out(regex=, json_schema=)`):
    each step masks the logits with the TokenDFA row of each sequence's
    state and advances the state, which stays on the device;
  * `hidden_states`, `embed` and `sequence_scores`: the hidden-state tap
    is found on the graph that runs, after fusion and quantization, so a
    QuantMatMul or PackedMatMul lm_head is found too (the reference's
    walk accepts only MatMul, Einsum and Gemm and raises on an int8 or
    packed lm_head); hidden_states runs only the nodes the tap needs;
  * `beam_search_tokens`: top-k over (B, W*V) a step, the caches
    gathered by parent beam into a second buffer.
  * multi-LoRA serving (`install_adapters`, reference :515-581): the
    per-row surgery of milli/transforms.py inject_multi_lora on the
    de-fused graph. `step(..., lora_idx=)` runs the adapted graph;
    without lora_idx the pre-surgery graph runs (the base model), as
    the reference's all-base program variant does.
Not ported yet, and raising NotImplementedError: windowed decode,
meshes.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backends.cpu.dequant import quantize_blocks
from ..backends.torch_exec.compiler import GraphExecutor
from ..device import resolve_device
from ..dtype import DType, host_to_device, to_host, to_torch
from ..milli.transforms import (fuse_parallel_matmuls, pack_matmul_nodes,
                                pair_cache_writes, quantize_matmul_weights)
from ..model import Model
from ..packed_format import PackedFormat
from ..tensor import PackedTensor
from ..weights import carry_weights


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet")


@dataclass(frozen=True)
class SamplingParams:
    """Sampling settings of a request. temperature==0 means
    greedy. top_k/top_p/min_p restrict the candidate set before the
    categorical draw; repetition_penalty divides positive / multiplies
    negative logits of already-seen tokens (prompt + generated, HF
    semantics); presence_penalty subtracts a flat amount from every
    seen token's logit and frequency_penalty subtracts per occurrence
    (OpenAI mu[j] -= c[j]*alpha_freq + 1[c[j]>0]*alpha_pres, counted
    over prompt + generated text, tracked as a (B, V) int32 count
    array)."""

    temperature: float = 1.0
    top_k: int = 0                   # 0 = disabled
    top_p: float = 1.0               # 1.0 = disabled
    min_p: float = 0.0               # 0.0 = disabled
    repetition_penalty: float = 1.0  # 1.0 = disabled
    presence_penalty: float = 0.0    # 0.0 = disabled (additive, OpenAI-style)
    frequency_penalty: float = 0.0   # 0.0 = disabled (additive, per count)
    seed: int = 0


def _uses_seen(sp: Optional[SamplingParams]) -> bool:
    """True when decoding must keep the (B, V) token-count array
    (repetition / presence / frequency penalties)."""
    return sp is not None and (sp.repetition_penalty != 1.0
                               or sp.presence_penalty != 0.0
                               or sp.frequency_penalty != 0.0)


def _rows_neutral(sp: Optional[SamplingParams]) -> tuple:
    """Per-row sampling parameter vector for one row: the row's own
    SamplingParams, or the neutral (greedy) settings when None."""
    if sp is None:
        return (0.0, 0, 1.0, 0.0, 1.0, 0.0, 0.0, 0)
    return (sp.temperature, sp.top_k, sp.top_p, sp.min_p,
            sp.repetition_penalty, sp.presence_penalty,
            sp.frequency_penalty, sp.seed)


def _rows_flags(sps) -> tuple:
    """Flags over a set of per-row SamplingParams: (any_sampled,
    any_topk, any_topp, any_minp, any_pen). With all False the pick is
    a plain argmax: batched greedy traffic pays nothing for per-row
    sampling support."""
    live = [sp for sp in sps if sp is not None]
    return (any(sp.temperature > 0.0 for sp in live),
            any(sp.top_k > 0 for sp in live),
            any(sp.top_p < 1.0 for sp in live),
            any(sp.min_p > 0.0 for sp in live),
            any(_uses_seen(sp) for sp in live))


def _rows_arrays(sps) -> tuple:
    """Stack per-row SamplingParams into the 8 (B,) arrays
    _pick_token_rows consumes (host numpy)."""
    cols = list(zip(*[_rows_neutral(sp) for sp in sps]))
    return (np.asarray(cols[0], np.float32), np.asarray(cols[1], np.int32),
            np.asarray(cols[2], np.float32), np.asarray(cols[3], np.float32),
            np.asarray(cols[4], np.float32), np.asarray(cols[5], np.float32),
            np.asarray(cols[6], np.float32), np.asarray(cols[7], np.uint32))


# the reference's buckets, then 2048..8192 for long prompts (buckets
# above an interface's max_len are dropped)
DEFAULT_PROMPT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"prompt length {n} exceeds the largest prompt bucket "
        f"{buckets[-1]}; pass larger prompt_buckets / max_len")


def _filtered_logits(lg: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """Temperature, top-k, top-p and min-p applied to (B, V) logits, in
    f32: softmax of the result is the distribution tokens are drawn
    from (reference _filtered_logits, interfaces/text.py:57)."""
    lg = lg.float() / sp.temperature
    if sp.top_k:
        kth = torch.topk(lg, sp.top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, -torch.inf)
    if sp.top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) <= sp.top_p
        thresh = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
        lg = lg.masked_fill(lg < thresh, -torch.inf)
    if sp.min_p > 0.0:
        probs = torch.softmax(lg, dim=-1)
        cut = sp.min_p * probs.amax(dim=-1, keepdim=True)
        lg = lg.masked_fill(probs < cut, -torch.inf)
    return lg


def _pick_token(logits: torch.Tensor, gen: Optional[torch.Generator],
                sp: Optional[SamplingParams],
                seen: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 tokens (reference _pick_token, :83).
    `seen` is the (B, V) count of prompt + generated tokens that the
    repetition / presence / frequency penalties read."""
    if seen is not None:
        lg = logits.float()
        emitted = seen > 0
        if sp.repetition_penalty != 1.0:
            pen = torch.where(lg > 0, lg / sp.repetition_penalty,
                              lg * sp.repetition_penalty)
            lg = torch.where(emitted, pen, lg)
        if sp.presence_penalty != 0.0:
            lg = lg - sp.presence_penalty * emitted.float()
        if sp.frequency_penalty != 0.0:
            lg = lg - sp.frequency_penalty * seen.float()
        logits = lg
    if sp is None or sp.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filtered_logits(logits, sp), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def _dfa_mask(logits: torch.Tensor, row: torch.Tensor,
              acc_state: torch.Tensor, eos: int) -> torch.Tensor:
    """Keep only the tokens the TokenDFA admits from each row's state;
    eos is admitted exactly in accepting states (reference _dfa_mask,
    :195). row: (B, V) int32 next-state table rows, acc_state: (B,)
    bool. Returns f32 logits with -inf at every other token."""
    allowed = row >= 0
    allowed[:, eos] = acc_state
    return torch.where(allowed, logits.float(), -torch.inf)


def _dfa_advance(row: torch.Tensor, tok: torch.Tensor, eos: int,
                 done: int) -> torch.Tensor:
    """Each row's state after emitting `tok`; eos parks the row in the
    `done` sink, which admits only further eos (reference :207)."""
    nxt = row.gather(1, tok[:, None])[:, 0]
    return torch.where(tok == eos, done, nxt)


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A bijective 32-bit integer hash (lowbias32, from Wellons' hash
    prospector) on a Python int or an int64 tensor of values in
    [0, 2^32): each product stays below 2^63, so int64 never wraps."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def _fold(key: int, data: int) -> int:
    """A new 32-bit key from a key and a number (jax.random.fold_in's
    role, on the host)."""
    return _mix32((_mix32(key & _M32) + data) & _M32)


def _gumbel_rows(key: int, seed: torch.Tensor, V: int) -> torch.Tensor:
    """(B, V) f32 standard Gumbel noise. Row b's noise is a function of
    (key, seed[b], token id) alone, so a request's draws do not depend
    on its neighbours in the batch, and the same seed under the same key
    gives the same draws wherever the row sits."""
    row = _mix32((seed.long() & _M32) ^ (key & _M32))              # (B,)
    tok = _mix32(torch.arange(V, device=seed.device, dtype=torch.int64))
    h = _mix32((row[:, None] + tok[None, :]) & _M32)
    u = ((h >> 8).float() + 0.5) * 2.0 ** -24                      # (0, 1)
    return -torch.log(-torch.log(u))


def _pick_token_rows(logits: torch.Tensor, key: int, rows, flags,
                     seen: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row sampling (reference _pick_token_rows, interfaces/text.py
    :143-192): (B, V) logits -> (B,) int64 tokens, with temperature,
    top-k, top-p, min-p, the three penalties and the seed each a (B,)
    tensor, in one batched pass. `flags` is _rows_flags over the rows'
    SamplingParams; `rows` the 8 tensors of _rows_arrays (None when no
    flag is set). `key` is a 32-bit int for this step.

    The draw is Gumbel-max: argmax(filtered logits + Gumbel noise) is a
    sample of softmax(filtered logits). The noise is hashed from (key,
    the row's seed, the token id), which keeps the reference's per-row
    streams (each row's seed folds into the step key) without one
    torch.Generator per row; jax.random's bits are not reproduced."""
    any_sampled, any_topk, any_topp, any_minp, any_pen = flags
    lg = logits.float()
    if any_pen and seen is not None:
        _, _, _, _, rep, pres, freq, _ = rows
        emitted = seen > 0
        pen = torch.where(lg > 0, lg / rep[:, None], lg * rep[:, None])
        lg = torch.where(emitted, pen, lg)
        lg = lg - pres[:, None] * emitted.float()
        lg = lg - freq[:, None] * seen.float()
    greedy = torch.argmax(lg, dim=-1)
    if not any_sampled:
        return greedy
    temp, topk, topp, minp, _, _, _, seed = rows
    slg = lg / torch.where(temp > 0, temp, 1.0)[:, None]
    V = lg.shape[-1]
    if any_topk:
        srt = torch.sort(slg, dim=-1, descending=True).values
        kth = srt.gather(1, (topk.long() - 1).clamp(0, V - 1)[:, None])
        slg = slg.masked_fill((topk[:, None] > 0) & (slg < kth), -torch.inf)
    if any_topp:
        # HF warper order: top-p ranks the post-top-k distribution
        srt = torch.sort(slg, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) <= topp[:, None]
        thresh = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
        slg = slg.masked_fill(slg < thresh, -torch.inf)
    if any_minp:
        probs = torch.softmax(slg, dim=-1)
        cut = minp[:, None] * probs.amax(dim=-1, keepdim=True)
        slg = slg.masked_fill((minp[:, None] > 0) & (probs < cut), -torch.inf)
    sampled = torch.argmax(slg + _gumbel_rows(key, seed, V), dim=-1)
    return torch.where(temp > 0, sampled, greedy)


def rows_tensors(sps, device: torch.device):
    """The 8 per-row sampling tensors of _pick_token_rows for a list of
    SamplingParams (None = greedy), from _rows_arrays, in one
    host-to-device copy that does not wait for the device."""
    cols = np.stack([np.asarray(a, np.float64) for a in _rows_arrays(sps)])
    t = host_to_device(cols, device)
    return (t[0].float(), t[1].long(), t[2].float(), t[3].float(),
            t[4].float(), t[5].float(), t[6].float(), t[7].long())


def _concat_device_layouts(pts: List[Dict]) -> Optional[Dict]:
    """Fuse packed_matmul device layouts (GPTQ/AWQ dicts) of one K
    column-wise: q, scales and offsets concatenate along N exactly; None
    when the members' bits, K or groups differ."""
    if (len({int(p["bits"]) for p in pts}) != 1
            or len({p["q"].shape[0] for p in pts}) != 1
            or len({p["scales"].shape[0] for p in pts}) != 1):
        return None
    out = {k: np.concatenate([p[k] for p in pts], axis=1)
           for k in ("q", "scales", "offsets")}
    out["bits"] = pts[0]["bits"]
    out["has_off"] = np.bool_(any(bool(p.get("has_off", True)) for p in pts))
    return out


class TextInferenceInterface:
    """Drives a unified step graph (see importers/recipes/llm):
    inputs  input_ids (B, S), pos (), cache_k_i / cache_v_i
            (B, H, MAX, D), weights
    outputs logits (B, S, V), new_cache_k_i / new_cache_v_i."""

    def __init__(self, model: Model, max_len: int,
                 cache_dtype: DType = DType.F32,
                 prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
                 tokenizer=None, eos_token_id=None,
                 quantize: Optional[str] = None,
                 weight_dtype: Optional[DType] = None,
                 window_models=None, mesh=None,
                 device=None):
        if window_models:
            raise _not_ported("windowed decode (window_models)")
        if mesh is not None:
            raise _not_ported("multi-device serving (mesh)")
        self.device = resolve_device(device)
        self.model = model
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        # the type a packed store entry dequantizes to on the host; the
        # KV cache's type never drags the weights down (reference
        # :284-291)
        if weight_dtype is None:
            weight_dtype = (cache_dtype if cache_dtype in
                            (DType.F32, DType.F16, DType.BF16)
                            else DType.BF16)
        self.weight_dtype = weight_dtype
        self.prompt_buckets = [b for b in prompt_buckets if b <= max_len]
        if not self.prompt_buckets:
            raise ValueError(f"no prompt bucket <= max_len={max_len} "
                             f"(buckets={list(prompt_buckets)})")
        self.tokenizer = tokenizer
        if eos_token_id is None or isinstance(eos_token_id, int):
            self.eos_token_id = eos_token_id
            self.eos_token_ids = (None if eos_token_id is None
                                  else (eos_token_id,))
        else:
            ids = tuple(int(e) for e in eos_token_id)
            self.eos_token_id = ids[0] if ids else None
            self.eos_token_ids = ids or None
        milli, weight_inputs = model.graph.to_milli()
        self.milli = milli
        # the numpy graph passes (milli/transforms.py)
        self._fused: Dict[str, List[Tuple[str, int]]] = \
            fuse_parallel_matmuls(milli, set(weight_inputs))
        live = [n for n in milli.inputs
                if n in weight_inputs or n in self._fused]
        self._quantized: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._packed: Dict[str, Dict[str, np.ndarray]] = {}
        # multi-LoRA serving (install_adapters): the adapter stacks
        self._lora_stacks: Dict[str, np.ndarray] = {}
        store = model.graph.store
        if quantize == "int8":
            self._quantized = quantize_matmul_weights(
                milli, live, lambda n: self._dense_np(n, DType.F32))
        elif quantize == "packed" or (quantize is None
                                      and store.packed_sources):
            # GGUF weights stay packed on the device (reference :341-355),
            # automatically when the loader recorded packed sources
            self._packed = pack_matmul_nodes(
                milli, live, store, sources=self._packed_sources_with_fused(
                    dict(store.packed_sources)))
        elif quantize in ("q4_0", "q8_0", "q5_0", "q4_k", "q6_k"):
            # host-quantize any dense checkpoint into GGUF blocks
            # (reference :356-388); weights that are not 2-D, or whose K
            # is not a multiple of max(64, block), stay dense
            fmt = PackedFormat[quantize.upper()]

            def q_source(n):
                def make():
                    w = self._dense_np(n, DType.F32)
                    if w.ndim != 2 or w.shape[0] % max(64, fmt.block_size):
                        return None
                    return PackedTensor(
                        quantize_blocks(np.ascontiguousarray(w.T), fmt),
                        fmt, (w.shape[1], w.shape[0]))           # (N, K)
                return make

            self._packed = pack_matmul_nodes(
                milli, live, store, sources={n: q_source(n) for n in live})
        elif quantize is not None:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.weight_names = [n for n in milli.inputs
                             if n in weight_inputs or n in self._fused
                             or n.endswith(("::scale", "::pscales",
                                            "::poffsets"))]
        self.weight_dtypes = {n: self._weight_dtype(n)
                              for n in self.weight_names}
        self.cache_in_names = [n for n in milli.inputs
                               if n.startswith("cache_")]
        self.cache_out_names = [n for n in milli.outputs
                                if n.startswith("new_cache_")]
        pos_tid = milli.inputs.get("pos")
        self._pos_per_row = (pos_tid is not None
                             and milli.tensors[pos_tid].info.rank == 1)
        info = model.graph.tensors[
            model.graph.by_name[self.cache_in_names[0]]].info
        self.n_heads = int(info.dims()[1].value())
        self.head_dim = int(info.dims()[3].value())
        self._exec = self._executor(milli)
        self._weights_dev: Optional[Dict[str, torch.Tensor]] = None
        # the batcher's loop and an HTTP thread's logprobs rescoring may
        # both make the first call: one upload, not two
        self._weights_lock = threading.Lock()
        # multi-LoRA serving: the slot of each adapter name (0 = base),
        # the per-row input the adapted graph takes and its executor
        self.adapter_slots: Dict[Optional[str], int] = {None: 0}
        self.row_extra_names: List[str] = []
        self._exec_lora: Optional[GraphExecutor] = None
        # constrained decoding: TokenDFAs by (regex, eos) and their
        # device tables by (pattern, table shape, eos)
        self._dfa_cache: Dict[Tuple, object] = {}
        self._dfa_device: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._hidden_exec: Optional[GraphExecutor] = None

    def _executor(self, milli) -> GraphExecutor:
        """An executor of `milli` with the port's own pass applied on a
        copy: `self.milli` stays the JAX package's graph node for node."""
        run = copy.copy(milli)
        pair_cache_writes(run)
        return GraphExecutor(run, self.device)

    # ------------------------------------------------------------------
    def _dense_np(self, n: str, dtype: Optional[DType] = None) -> np.ndarray:
        """Dense host weight by milli input name; a fused input is its
        members concatenated column-wise (reference :457). A packed store
        entry dequantizes to `dtype` (default weight_dtype)."""
        store = self.model.graph.store
        dt = dtype or self.weight_dtype
        if n in self._fused:
            return np.concatenate([store.get_numeric(m, dt).numpy()
                                   for m, _ in self._fused[n]], axis=1)
        return store.get_numeric(n, dt).numpy()

    def _packed_sources_with_fused(self, sources: Dict) -> Dict:
        """Extend packed sources with fused entries (reference
        :469-513): PackedTensor rows are output channels, so a fused
        (N1+N2, K) tensor is the raw byte concatenation of its members;
        GPTQ/AWQ device-layout dicts concatenate column-wise. Members of
        different formats fuse to None: the fused weight then stays a
        dense MatMul."""
        for fname, members in self._fused.items():
            if not all(m in sources for m, _ in members):
                continue

            def make(members=members):
                pts = [sources[m]() for m, _ in members]
                if pts and all(isinstance(p, dict) for p in pts):
                    return _concat_device_layouts(pts)
                if not all(isinstance(p, PackedTensor) for p in pts):
                    return None
                fmts = {p.fmt for p in pts}
                if len(fmts) != 1 or any(len(p.shape) != 2 for p in pts):
                    return None
                K = pts[0].shape[1]
                if any(p.shape[1] != K for p in pts):
                    return None
                data = np.concatenate(
                    [np.frombuffer(p.data, dtype=np.uint8) for p in pts])
                return PackedTensor(data.tobytes(), pts[0].fmt,
                                    (sum(p.shape[0] for p in pts), K))

            sources[fname] = make
        return sources

    def _declared(self, n: str) -> DType:
        """The element type the model declares for a weight input (a
        fused input has its members' type)."""
        g = self.model.graph
        name = self._fused[n][0][0] if n in self._fused else n
        return g.tensors[g.by_name[name]].info.dtype

    def _weight_dtype(self, n: str) -> DType:
        """The device type of weight input `n`: f32 scales and offsets,
        int8 quantized matrices, packed q in uint8 (bits 4) or int8
        (bits 8), else the model's declared type."""
        if n.endswith(("::scale", "::pscales", "::poffsets")):
            return DType.F32
        if n in self._lora_stacks:
            return DType.from_numpy(self._lora_stacks[n].dtype)
        if n in self._quantized:
            return DType.I8
        if n in self._packed:
            return DType.U8 if int(self._packed[n]["bits"]) == 4 else DType.I8
        return self._declared(n)

    def host_weights(self, names: Optional[Sequence[str]] = None
                     ) -> Dict[str, np.ndarray]:
        """{milli input name: host array} of `names` (default all the
        weights), assembled as the reference's `_weights` does
        (interfaces/text.py:584-633)."""
        out = {}
        for n in self.weight_names if names is None else names:
            if n.endswith("::scale"):
                out[n] = self._quantized[n[:-7]][1]
            elif n in self._quantized:
                out[n] = self._quantized[n][0]
            elif n.endswith("::pscales"):
                out[n] = self._packed[n[:-9]]["scales"]
            elif n.endswith("::poffsets"):
                out[n] = self._packed[n[:-10]]["offsets"]
            elif n in self._packed:
                out[n] = self._packed[n]["q"]
            elif n in self._lora_stacks:
                out[n] = self._lora_stacks[n]
            else:
                out[n] = self._dense_np(n)
        return out

    def load_weights(self, arrays: Mapping[str, np.ndarray]) -> None:
        """Upload a weight set named as `host_weights` names it."""
        self._weights_dev = carry_weights(arrays, self.weight_dtypes,
                                          self.device)

    def share_weights(self, other: "TextInferenceInterface") -> None:
        """Take `other`'s device tensor for every model weight both
        interfaces name with one type (`other` must be an interface over
        the same model, as the batcher load_adapter builds is); upload
        the rest, the adapter stacks always (their slot count differs).
        Weights are read only, so sharing is safe. A fused weight of
        `other` shares nothing with a de-fused interface's members."""
        theirs = other._weights()
        shared = {n: theirs[n] for n in self.weight_names
                  if n in theirs and n not in self._lora_stacks
                  and other.weight_dtypes.get(n) is self.weight_dtypes[n]}
        rest = [n for n in self.weight_names if n not in shared]
        dev = carry_weights(self.host_weights(rest),
                            {n: self.weight_dtypes[n] for n in rest},
                            self.device)
        self._weights_dev = {**dev, **shared}

    def _weights(self) -> Dict[str, torch.Tensor]:
        if self._weights_dev is None:
            with self._weights_lock:
                if self._weights_dev is None:
                    self.load_weights(self.host_weights())
        return self._weights_dev

    def _vocab_size(self) -> int:
        info = self.model.graph.tensors[
            self.model.graph.by_name["logits"]].info
        return int(info.dims()[-1].value())

    def fresh_cache(self, batch: int) -> List[torch.Tensor]:
        out = []
        for n in self.cache_in_names:
            info = self.model.graph.tensors[self.model.graph.by_name[n]].info
            dims = tuple(batch if not d.is_known else int(d.value())
                         for d in info.dims())
            out.append(torch.zeros(dims, dtype=to_torch(self.cache_dtype),
                                   device=self.device))
        return out

    def _feeds(self, ids: torch.Tensor, pos: torch.Tensor,
               caches: List[torch.Tensor],
               lora_idx: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        if self._pos_per_row:
            pos = pos.reshape(-1).expand(ids.shape[0])
        feeds = {"input_ids": ids, "pos": pos}
        feeds.update(zip(self.cache_in_names, caches))
        feeds.update(self._weights() if lora_idx is None
                     else self.weights_with_rows([lora_idx]))
        return feeds

    def step(self, ids: torch.Tensor, pos: torch.Tensor,
             caches: List[torch.Tensor],
             lora_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step graph run: ids (B, S) int64 and pos () or (B,) int64
        on the device -> logits (B, S, V). `caches` are updated in
        place. lora_idx: (B,) int64 adapter slots on the device, which
        run the adapted graph (install_adapters); without it the base
        model runs."""
        feeds = self._feeds(ids, pos, caches, lora_idx)
        run = self._exec if lora_idx is None else self._exec_lora
        return run(feeds)["logits"]

    # ------------------------------------------------------------------
    def _prompt(self, prompt_ids) -> Tuple[torch.Tensor, int]:
        """(B, L) prompt -> its zero-padded bucket on the device, and L."""
        prompt_ids = np.asarray(prompt_ids, dtype=np.int64)
        if prompt_ids.ndim == 1:
            prompt_ids = prompt_ids[None]
        B, L = prompt_ids.shape
        padded = np.zeros((B, _bucket(L, self.prompt_buckets)), np.int64)
        padded[:, :L] = prompt_ids
        return torch.from_numpy(padded).to(self.device), L

    def _decode(self, prompt_ids, n_new: int, caches,
                sampling: Optional[SamplingParams],
                logit_bias: Optional[np.ndarray], keep_logits: bool,
                constraint=None):
        """Prefill, then n_new - 1 decode steps. Returns (tokens (B,
        n_new) on the device, per-token f32 logits or None).

        Each token is picked in the reference's order (:756-800): the
        bias is added, the constraint's mask applied (its table row of
        each sequence's state), the token picked with the penalties, and
        the state advanced; the state never leaves the device."""
        ids, L = self._prompt(prompt_ids)
        B = ids.shape[0]
        if caches is None:
            caches = self.fresh_cache(B)
        bias = (None if logit_bias is None else torch.as_tensor(
            np.asarray(logit_bias, np.float32), device=self.device))
        if constraint is not None:
            trans, acc = self._dfa_tables(constraint)
            eos, done = int(constraint.eos_token_id), int(constraint.done)
            dstate = torch.full((B,), int(constraint.start),
                                dtype=torch.int64, device=self.device)
        gen = None
        if sampling is not None and sampling.temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(sampling.seed))
        pos = torch.zeros((), dtype=torch.int64, device=self.device)
        last = self.step(ids, pos, caches)[:, L - 1, :]
        seen = None
        if _uses_seen(sampling):
            # prompt tokens count as seen (only the real prefix)
            seen = torch.zeros((B, last.shape[-1]), dtype=torch.int32,
                               device=self.device)
            seen.scatter_add_(1, ids[:, :L],
                              torch.ones_like(ids[:, :L], dtype=torch.int32))
        toks, kept = [], []
        pos = pos + L
        for i in range(n_new):
            if i:
                last = self.step(toks[-1][:, None], pos, caches)[:, -1, :]
                pos = pos + 1
            if bias is not None:
                last = last + bias
            if constraint is not None:
                row = trans[dstate]
                last = _dfa_mask(last, row, acc[dstate], eos)
            if keep_logits:
                kept.append(last.float())
            tok = _pick_token(last, gen, sampling, seen)
            if constraint is not None:
                dstate = _dfa_advance(row, tok, eos, done).long()
            if seen is not None:
                seen.scatter_add_(1, tok[:, None],
                                  torch.ones_like(tok[:, None],
                                                  dtype=torch.int32))
            toks.append(tok)
        out = (torch.stack(toks, dim=1) if toks
               else torch.zeros((B, 0), dtype=torch.int64, device=self.device))
        return out, (torch.stack(kept, dim=1) if keep_logits and kept
                     else None)

    def generate_tokens(self, prompt_ids: np.ndarray, n_new: int,
                        caches=None,
                        sampling: Optional[SamplingParams] = None,
                        constraint=None,
                        logit_bias: Optional[np.ndarray] = None
                        ) -> np.ndarray:
        """prompt_ids (B, L) int64, the same L for every row -> (B,
        n_new) int64. sampling=None is greedy; otherwise tokens are
        drawn from a torch.Generator seeded with sampling.seed.
        logit_bias: (V,) f32 added to every step's logits. constraint:
        a TokenDFA (compile_constraint); every emitted token keeps the
        output inside its language, and eos follows once it is
        complete."""
        toks, _ = self._decode(prompt_ids, n_new, caches, sampling,
                               logit_bias, keep_logits=False,
                               constraint=constraint)
        return toks.cpu().numpy()

    def generate_with_logits(self, prompt_ids: np.ndarray, n_new: int,
                             sampling: Optional[SamplingParams] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """generate_tokens, also returning the f32 logits each token was
        picked from: (B, n_new) tokens, (B, n_new, V) logits."""
        toks, logits = self._decode(prompt_ids, n_new, None, sampling,
                                    None, keep_logits=True)
        return toks.cpu().numpy(), logits.cpu().numpy()

    def logits(self, prompt_ids: np.ndarray) -> np.ndarray:
        """Single forward: (B, L) -> (B, L, V) logits (prefill step)."""
        ids, L = self._prompt(prompt_ids)
        pos = torch.zeros((), dtype=torch.int64, device=self.device)
        out = self.step(ids, pos, self.fresh_cache(ids.shape[0]))
        return to_host(out[:, :L, :])

    def run_string_in_string_out(self, text: str, n_new: int = 32,
                                 sampling: Optional[SamplingParams] = None,
                                 regex: Optional[str] = None,
                                 json_schema=None) -> str:
        if self.tokenizer is None:
            raise ValueError("no tokenizer configured")
        constraint = None
        if regex is not None or json_schema is not None:
            constraint = self.compile_constraint(regex, json_schema)
        ids = np.asarray(self.tokenizer.encode(text), dtype=np.int64)[None]
        toks = self.generate_tokens(ids, n_new, sampling=sampling,
                                    constraint=constraint)[0]
        eos_ids = ((constraint.eos_token_id,) if constraint is not None
                   else self.eos_token_ids)
        if eos_ids:
            eos = np.nonzero(np.isin(toks, np.asarray(eos_ids)))[0]
            if eos.size:
                toks = toks[:eos[0]]
        return self.tokenizer.decode([int(t) for t in toks])

    # -- constrained decoding ------------------------------------------
    def compile_constraint(self, regex: Optional[str] = None,
                           json_schema=None):
        """A regex or JSON schema compiled into a TokenDFA bound to this
        interface's tokenizer and vocab width, cached per (regex, eos)
        (reference :1391-1421). A byte-tokenizer model without an eos id
        takes the tokenizer's, as the reference does."""
        from ..constrained import compile_token_dfa, json_schema_to_regex
        from ..tokenizer import ByteTokenizer

        if (regex is None) == (json_schema is None):
            raise ValueError("pass exactly one of regex / json_schema")
        if json_schema is not None:
            regex = json_schema_to_regex(json_schema)
        if self.tokenizer is None:
            raise ValueError("constrained decoding needs a tokenizer")
        if self.eos_token_id is None:
            if not isinstance(self.tokenizer, ByteTokenizer):
                raise ValueError(
                    "constrained decoding needs eos_token_id (the DFA "
                    "stops generation by emitting eos once the pattern "
                    "is complete)")
            self.eos_token_id = ByteTokenizer.EOS
            self.eos_token_ids = (ByteTokenizer.EOS,)
        key = (regex, self.eos_token_id)
        hit = self._dfa_cache.get(key)
        if hit is None:
            hit = compile_token_dfa(regex, self.tokenizer, self.eos_token_id,
                                    vocab_size=self._vocab_size())
            self._dfa_cache[key] = hit
        return hit

    def _dfa_tables(self, constraint) -> Tuple[torch.Tensor, torch.Tensor]:
        """(trans (S+1, V) int32, accepting (S+1,) bool) on the device,
        uploaded once per (pattern, table shape, eos) and reused
        (reference :957-978)."""
        key = (constraint.pattern, constraint.trans.shape,
               constraint.eos_token_id)
        hit = self._dfa_device.get(key)
        if hit is None:
            V = self._vocab_size()
            if constraint.trans.shape[1] != V:
                raise ValueError(
                    f"constraint vocab width {constraint.trans.shape[1]} != "
                    f"model vocab {V}; pass vocab_size={V} to "
                    f"compile_token_dfa")
            hit = (host_to_device(constraint.trans, self.device),
                   host_to_device(constraint.accepting, self.device))
            self._dfa_device[key] = hit
        return hit

    # -- hidden states, embeddings, sequence scores ---------------------
    def _hidden_tid(self) -> int:
        """tid of the final hidden state, the lm_head's activation input,
        in the graph that runs, found by walking back from the logits
        output through the elementwise tail (bias Add, softcap
        Mul/Tanh/Div, Cast/Reshape), as the reference does (:1236-1277),
        following the deepest input. The lm_head may be a MatMul, Einsum
        or Gemm, or, after quantization, a QuantMatMul or PackedMatMul,
        whose activation is input 0."""
        milli = self._exec.graph
        producer = {t: node for node in milli.nodes for t in node.outputs}
        depth: Dict[int, int] = {}
        for node in milli.nodes:
            d = 1 + max((depth.get(i, 0) for i in node.inputs
                         if i is not None), default=0)
            for t in node.outputs:
                depth[t] = d
        tid = milli.outputs["logits"]
        for _ in range(16):
            node = producer.get(tid)
            if node is None:
                break
            kind = node.op.KIND
            if kind in ("QuantMatMul", "PackedMatMul"):
                return node.inputs[0]
            ins = [i for i in node.inputs if i is not None]
            deepest = max(ins, key=lambda i: depth.get(i, 0), default=None)
            if kind in ("MatMul", "Einsum", "Gemm"):
                return deepest
            if kind in ("SimpleBinary", "SimpleUnary", "Cast", "CastLike",
                        "Reshape", "Transpose", "Identity", "Squeeze",
                        "Unsqueeze") and deepest is not None:
                tid = deepest
                continue
            break
        raise ValueError("could not locate the lm_head activation in "
                         "this graph (no hidden-state tap)")

    def _hidden_executor(self) -> GraphExecutor:
        """An executor of the running graph pruned to the nodes the
        hidden-state tap needs, with the tap as its one output `hidden`
        (the reference's _trace_graph(..., [tap]), :1279-1323)."""
        if self._hidden_exec is None:
            with self._weights_lock:
                if self._hidden_exec is None:
                    run = self._exec.graph
                    tap = self._hidden_tid()
                    need, kept = {tap}, []
                    for node in reversed(run.nodes):
                        if need.intersection(node.outputs):
                            kept.append(node)
                            need.update(i for i in node.inputs
                                        if i is not None)
                    pruned = copy.copy(run)
                    pruned.nodes = kept[::-1]
                    pruned.outputs = {"hidden": tap}
                    self._hidden_exec = GraphExecutor(pruned, self.device)
        return self._hidden_exec

    def hidden_states(self, prompt_ids: np.ndarray) -> np.ndarray:
        """Single forward: (B, L) -> (B, L, E) final hidden states (the
        lm_head's input), from a prefill that stops at the tap. Backs
        /v1/embeddings."""
        ids, L = self._prompt(prompt_ids)
        pos = torch.zeros((), dtype=torch.int64, device=self.device)
        feeds = self._feeds(ids, pos, self.fresh_cache(ids.shape[0]))
        return to_host(self._hidden_executor()(feeds)["hidden"][:, :L])

    def sequence_scores(self, full_ids: np.ndarray, start, lens
                        ) -> np.ndarray:
        """(B, L) right-padded token rows -> (B,) mean log-probability of
        the tokens in positions [start_i, lens_i) under teacher forcing
        (reference :1325-1365). One batched prefill; the log-softmax,
        gather and masked mean run on the device and only (B,) comes
        back."""
        full_ids = np.asarray(full_ids, np.int64)
        B, L = full_ids.shape
        Sb = _bucket(max(L - 1, 1), self.prompt_buckets)
        padded = np.zeros((B, Sb), np.int64)
        padded[:, :L - 1] = full_ids[:, :-1]
        tgt = np.zeros((B, Sb), np.int64)
        tgt[:, :L - 1] = full_ids[:, 1:]
        ids = torch.from_numpy(padded).to(self.device)
        targets = torch.from_numpy(tgt).to(self.device)
        starts = torch.as_tensor(np.asarray(start, np.int64),
                                 device=self.device)
        lengths = torch.as_tensor(np.asarray(lens, np.int64),
                                  device=self.device)
        pos0 = torch.zeros((), dtype=torch.int64, device=self.device)
        logits = self.step(ids, pos0, self.fresh_cache(B))
        lp = torch.log_softmax(logits.float(), dim=-1)
        chosen = lp.gather(2, targets[:, :, None])[..., 0]
        pos = torch.arange(Sb, device=self.device)[None, :]
        mask = (pos >= starts[:, None] - 1) & (pos < lengths[:, None] - 1)
        n = mask.sum(-1).clamp_min(1)
        return ((chosen * mask).sum(-1) / n).cpu().numpy()

    def embed(self, ids_list: Sequence[np.ndarray],
              pooling: str = "last") -> List[np.ndarray]:
        """Pooled text embeddings (reference :1367-1389): the token lists
        right-padded into one hidden-states prefill, each row pooled
        over its own length (exact under the causal mask), then
        L2-normalized. Shared by /v1/embeddings and `cli embed`."""
        if pooling not in ("last", "mean"):
            raise ValueError(f"unknown pooling {pooling!r} (last|mean)")
        ids_list = [np.asarray(a, np.int64).reshape(-1) for a in ids_list]
        if not ids_list or any(a.size == 0 for a in ids_list):
            raise ValueError("inputs must be non-empty token lists")
        L = max(a.size for a in ids_list)
        batch = np.zeros((len(ids_list), L), np.int64)
        for i, a in enumerate(ids_list):
            batch[i, :a.size] = a
        h = self.hidden_states(batch)
        out = []
        for i, a in enumerate(ids_list):
            hv = h[i, :a.size].astype(np.float64)
            v = hv[-1] if pooling == "last" else hv.mean(0)
            out.append(v / (np.linalg.norm(v) + 1e-12))
        return out

    # -- beam search ----------------------------------------------------
    def _reorder_caches(self, src: List[torch.Tensor],
                        dst: List[torch.Tensor], rows: torch.Tensor) -> None:
        """dst[j] = src[j][rows]: the caches gathered by parent beam into
        the second buffer (whole caches, as the reference's c[rows])."""
        for a, b in zip(src, dst):
            torch.index_select(a, 0, rows, out=b)

    def beam_search_tokens(self, prompt_ids: np.ndarray, n_new: int,
                           beam: int = 4, length_penalty: float = 0.0,
                           eos_token_id: Optional[int] = None,
                           return_scores: bool = False):
        """(B, L) prompt -> (B, n_new) best beam sequences (reference
        _beam_program, :868-955): a prefill at B rows, the caches
        repeated to B*W rows, then each step a top-k over (B, W*V) of
        the running log-probabilities and the caches gathered by parent
        beam; finished beams extend only with eos. The best beam by
        score, divided by length ** length_penalty when that is not 0.
        Everything runs on the device; the tokens come back once.
        return_scores: also return the best beams' summed
        log-probabilities (B,) f32, before the length penalty."""
        ids, L = self._prompt(prompt_ids)
        B, W = ids.shape[0], int(beam)
        R = B * W
        eos = (eos_token_id if eos_token_id is not None
               else (self.eos_token_id if self.eos_token_id is not None
                     else -1))
        dev = self.device
        pos = torch.zeros((), dtype=torch.int64, device=dev)
        caches = self.fresh_cache(B)
        last = torch.log_softmax(
            self.step(ids, pos, caches)[:, L - 1, :].float(), dim=-1)
        V = last.shape[-1]
        top_s, top_i = torch.topk(last, W, dim=-1)             # (B, W)
        cur = top_i.reshape(-1)
        scores = top_s.reshape(-1)
        caches = [c.repeat_interleave(W, dim=0) for c in caches]
        spare = [torch.empty_like(c) for c in caches]
        alive = cur != eos
        hist = torch.zeros((R, n_new), dtype=torch.int64, device=dev)
        hist[:, 0] = cur
        eos_only = torch.full((V,), -torch.inf, device=dev)
        eos_only[eos] = 0.0
        base = torch.arange(B, device=dev)[:, None] * W
        pos = pos + L
        for i in range(1, n_new):
            lp = torch.log_softmax(
                self.step(cur[:, None], pos, caches)[:, -1, :].float(), dim=-1)
            lp = torch.where(alive[:, None], lp, eos_only[None])
            flat = (scores[:, None] + lp).reshape(B, W * V)
            top_s, top_i = torch.topk(flat, W, dim=-1)
            rows = (base + top_i // V).reshape(-1)
            token = (top_i % V).reshape(-1)
            self._reorder_caches(caches, spare, rows)
            caches, spare = spare, caches
            hist = hist[rows]
            hist[:, i] = token
            cur = token
            scores = top_s.reshape(-1)
            alive = alive[rows] & (cur != eos)
            pos = pos + 1
        norm = scores.reshape(B, W)
        if length_penalty != 0.0:
            hit = hist == eos
            lengths = torch.minimum(
                hit.int().argmax(dim=1)
                + torch.where(hit.any(dim=1), 1, n_new), torch.tensor(
                    n_new, device=dev))
            norm = norm / lengths.reshape(B, W).float() ** length_penalty
        best = norm.argmax(dim=1)
        pick = (torch.arange(B, device=dev), best)
        out = hist.reshape(B, W, n_new)[pick].cpu().numpy()
        if return_scores:
            return out, scores.reshape(B, W)[pick].cpu().numpy()
        return out

    # -- multi-LoRA serving ----------------------------------------------
    def install_adapters(self, adapters: Dict[str, Dict[str, Tuple]]):
        """Install named adapters for per-row selection (reference
        :515-581). adapters maps an adapter name to {milli weight input:
        (A (K, r), B (r, N), scale)}. The graph is de-fused first (the
        adapters target per-projection weights), `self.milli` becomes the
        adapted graph, and the pre-surgery graph keeps running for
        callers that pass no lora_idx; both carry pair_cache_writes.
        `adapter_slots` maps names to slots (0 = base). Must be called
        before the weights are uploaded."""
        from ..milli.transforms import inject_multi_lora

        if self._weights_dev is not None:
            raise ValueError("install_adapters before any program "
                             "compiles (fresh interface)")
        if self.row_extra_names:
            raise ValueError("adapters already installed")
        targeted = {w for a in adapters.values() for w in a}
        quantized = set(self._quantized) | set(self._packed)
        if self._fused and quantized:
            raise ValueError(
                "adapters on a quantized graph with fused matmuls not "
                "supported (int8 or packed weights): serve adapters over "
                "dense weights")
        if targeted & quantized:
            raise ValueError(f"adapters on quantized weights not supported: "
                             f"{sorted(targeted & quantized)}")
        # de-fuse: adapters target per-projection weight inputs, and
        # nothing has run yet
        milli, weight_inputs = self.model.graph.to_milli()
        names = list(adapters)
        missing = sorted(w for w in targeted if w not in milli.inputs)
        if missing:
            raise ValueError(
                f"adapter targets are not runtime weight inputs of this "
                f"graph: {missing} (small weights are baked as "
                f"constants; available: "
                f"{[n for n in milli.inputs if n in weight_inputs][:8]}...)")
        store = self.model.graph.store
        base = copy.deepcopy(milli)
        self._lora_stacks = inject_multi_lora(
            milli, [adapters[n] for n in names],
            lambda n: store.get_numeric(n, self.weight_dtype).numpy())
        self.milli = milli
        self._fused = {}
        self.weight_names = ([n for n in milli.inputs if n in weight_inputs]
                             + sorted(self._lora_stacks))
        self.weight_dtypes = {n: self._weight_dtype(n)
                              for n in self.weight_names}
        self.adapter_slots = {None: 0,
                              **{n: i + 1 for i, n in enumerate(names)}}
        self.row_extra_names = ["lora_idx"]
        self._exec = self._executor(base)
        self._exec_lora = self._executor(milli)
        self._hidden_exec = None

    def weights_with_rows(self, row_extras: Sequence[torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
        """The weights with the per-row extra inputs (lora_idx) added:
        the feeds the adapted graph takes beside ids, pos and caches."""
        return {**self._weights(), **dict(zip(self.row_extra_names,
                                              row_extras))}
