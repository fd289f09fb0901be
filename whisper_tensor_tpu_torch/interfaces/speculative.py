"""Speculative decoding: a small draft model proposes a block of tokens,
the target model verifies the whole block in one forward and accepts the
longest matching prefix, emitting 1..k tokens per target evaluation.

The port's copy of whisper_tensor_tpu/interfaces/speculative.py. The
reference runs the whole draft-verify-accept loop as one jitted
`lax.while_loop` (:82-230); here it runs eagerly, a round at a time:
  * the draft runs k single-token steps (one more than it proposes, so
    its cache covers the all-accepted case), then the target verifies
    one k-token block at `pos` (a k-row prefill through the step graph);
  * `pos`, the current token, the output buffer and the counts stay on
    the device as (B,) tensors, and acceptance is computed there;
  * the host reads one flag, "every row is done", once a round, and
    skips that read for the first ceil((n_new - 1) / k) rounds, since a
    round emits at most k tokens a row and no row can finish sooner.

Greedy acceptance (temperature 0): a draft token is accepted iff it
equals the target's argmax given the same prefix, and the correction
token is the target's own argmax, so the output is token-exact against
plain greedy decoding of the target, whatever the draft. temperature > 0
uses modified rejection sampling (Leviathan et al., "Fast Inference
from Transformers via Speculative Decoding") on a torch.Generator seeded
with the sampling seed: accept draft token x with probability
min(1, p_target(x) / p_draft(x)); on the first rejection, sample the
renormalized residual max(0, p_t - p_d). Emitted tokens are then
distributed as target-only sampling at the same temperature / top-k /
top-p / min-p (jax.random's bits are not reproduced).

Cache discipline: a verify writes the target's cache at pos..pos+k-1,
and positions past the accepted prefix hold wrong futures. That is safe
because a step at position p attends only to entries <= p, and pos
advances over accepted (true-history) entries alone, so a stale entry is
overwritten before it becomes visible.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .text import (SamplingParams, TextInferenceInterface, _bucket,
                   _filtered_logits, _uses_seen)


class SpeculativeDecoder:
    """k: speculation block length. The draft proposes k-1 tokens a
    round and the target verifies a k-token block (k-1 proposals behind
    the current token), emitting between 1 and k tokens a round.

    Both interfaces must be built from unified step graphs over the
    same vocabulary, on one device. Batches > 1 need pos_per_row step
    graphs for both (rows accept different amounts and their positions
    diverge, as in continuous batching)."""

    def __init__(self, target: TextInferenceInterface,
                 draft: TextInferenceInterface, k: int = 4):
        if k < 2:
            raise ValueError("k must be >= 2 (k-1 draft proposals)")
        if target._vocab_size() != draft._vocab_size():
            raise ValueError(
                f"target vocab {target._vocab_size()} != draft vocab "
                f"{draft._vocab_size()}: speculative decoding compares "
                "token ids across the two models")
        if target.device != draft.device:
            raise ValueError(f"target on {target.device}, draft on "
                             f"{draft.device}: both must share a device")
        self.target = target
        self.draft = draft
        self.k = k
        self.device = target.device
        self.last_rounds = 0

    @staticmethod
    def _pos(iface: TextInferenceInterface, pos: torch.Tensor):
        """The (B,) positions as `iface`'s step graph takes them: a
        scalar-pos graph (only at B = 1) takes the one row's."""
        return pos if iface._pos_per_row else pos.reshape(())

    # ------------------------------------------------------------------
    def generate_tokens(self, prompt_ids: np.ndarray, n_new: int,
                        sampling: Optional[SamplingParams] = None
                        ) -> np.ndarray:
        """prompt_ids: (B, L) or (L,). Returns (B, n_new) int64.

        sampling None / temperature 0: greedy, token-exact against
        target.generate_tokens. temperature > 0: modified rejection
        sampling; the history-dependent penalties are refused, since the
        acceptance test needs fixed per-position distributions."""
        if _uses_seen(sampling):
            raise ValueError("history-dependent penalties "
                             "(repetition_penalty / presence_penalty / "
                             "frequency_penalty) are not supported in "
                             "speculative decoding")
        ids = np.asarray(prompt_ids, np.int64)
        if ids.ndim == 1:
            ids = ids[None]
        B, L = ids.shape
        if B > 1 and not (self.target._pos_per_row
                          and self.draft._pos_per_row):
            raise ValueError(
                "batch > 1 speculative decoding needs pos_per_row=True "
                "step graphs for both target and draft (rows accept "
                "different amounts: their positions diverge)")
        K = self.k
        bucket = _bucket(L, self.target.prompt_buckets)
        need = bucket + n_new + 2 * K
        for which, iface in (("target", self.target), ("draft", self.draft)):
            if need > iface.max_len:
                raise ValueError(
                    f"{which} max_len {iface.max_len} too small: needs "
                    f"bucket {bucket} + n_new {n_new} + 2k slack = {need}")
        sp = (sampling if sampling is not None and sampling.temperature > 0
              else None)
        dev = self.device
        gen = None
        if sp is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(sp.seed))
        padded = np.zeros((B, bucket), np.int64)
        padded[:, :L] = ids
        ids_d = torch.from_numpy(padded).to(dev)
        t_caches = self.target.fresh_cache(B)
        d_caches = self.draft.fresh_cache(B)
        zero = torch.zeros(B, dtype=torch.int64, device=dev)
        last = self.target.step(ids_d, self._pos(self.target, zero),
                                t_caches)[:, L - 1, :]
        self.draft.step(ids_d, self._pos(self.draft, zero), d_caches)
        if sp is None:
            cur = torch.argmax(last, dim=-1)
        else:
            cur = self._draw(torch.softmax(_filtered_logits(last, sp), -1),
                             gen)
        cap = n_new + K                     # emission overshoot room
        out = torch.zeros((B, cap + 1), dtype=torch.int64, device=dev)
        out[:, 0] = cur
        pos = torch.full((B,), L, dtype=torch.int64, device=dev)
        count = torch.ones(B, dtype=torch.int64, device=dev)
        ar = torch.arange(K, device=dev)
        rounds = 0
        unchecked = -(-(n_new - 1) // K)    # rounds before any row can end
        while True:
            if rounds >= unchecked and not bool((count < n_new).any()):
                break
            active = count < n_new
            if sp is None:
                a, emit = self._greedy_round(cur, pos, d_caches, t_caches)
            else:
                a, emit = self._sampled_round(cur, pos, d_caches, t_caches,
                                              sp, gen)
            m = torch.where(active, a + 1, 0)
            cols = count[:, None] + ar[None, :]
            valid = (ar[None, :] <= a[:, None]) & active[:, None] \
                & (cols < cap)
            out.scatter_(1, torch.where(valid, cols, cap), emit)
            nxt = emit.gather(1, a[:, None])[:, 0]
            cur = torch.where(active, nxt, cur)
            pos = pos + m
            count = count + m
            rounds += 1
        # tokens emitted per verify round are 1 + accepted proposals, so
        # acceptance = (n / rounds - 1) / (k - 1)
        self.last_rounds = rounds
        return out[:, :n_new].cpu().numpy()

    # ------------------------------------------------------------------
    def _draft_steps(self, cur, pos, d_caches, sp, gen):
        """k draft steps from `cur` at `pos`: the (B, k-1) proposals,
        and under sampling the (B, k, V) f32 draft distributions."""
        tok, probs, toks = cur, [], []
        for i in range(self.k):
            lg = self.draft.step(tok[:, None],
                                 self._pos(self.draft, pos + i),
                                 d_caches)[:, -1, :]
            if sp is None:
                tok = torch.argmax(lg, dim=-1)
            else:
                p = torch.softmax(_filtered_logits(lg, sp), dim=-1)
                tok = self._draw(p, gen)
                probs.append(p)
            toks.append(tok)
        q = torch.stack(toks[:-1], dim=1)
        return q, (torch.stack(probs, dim=1) if probs else None)

    def _verify(self, cur, q, pos, t_caches) -> torch.Tensor:
        """The target's (B, k, V) logits over [cur, q] at `pos`."""
        seq = torch.cat([cur[:, None], q], dim=1)
        return self.target.step(seq, self._pos(self.target, pos), t_caches)

    def _greedy_round(self, cur, pos, d_caches, t_caches):
        """Accept proposals while they equal the target's argmax; emit
        the target's argmaxes (a + 1 of them)."""
        q, _ = self._draft_steps(cur, pos, d_caches, None, None)
        t_pred = torch.argmax(self._verify(cur, q, pos, t_caches), dim=-1)
        match = (q == t_pred[:, :-1]).long()
        return torch.cumprod(match, dim=1).sum(dim=1), t_pred

    def _sampled_round(self, cur, pos, d_caches, t_caches, sp, gen):
        """Modified rejection sampling: accept proposal x_i with
        probability min(1, p_t(x_i) / p_d(x_i)); at the first rejection
        sample the renormalized residual max(0, p_t - p_d). When all k-1
        proposals are accepted there is no proposal at slot k-1, so p_d
        there is 0 and the residual is p_t."""
        K = self.k
        q, pd_full = self._draft_steps(cur, pos, d_caches, sp, gen)
        lg = self._verify(cur, q, pos, t_caches)
        B, V = lg.shape[0], lg.shape[-1]
        pt_full = torch.softmax(_filtered_logits(
            lg.reshape(B * K, V), sp), dim=-1).reshape(B, K, V)
        pd = pd_full[:, :K - 1].gather(2, q[..., None])[..., 0]
        pt = pt_full[:, :K - 1].gather(2, q[..., None])[..., 0]
        u = torch.rand((B, K - 1), generator=gen, device=self.device)
        accept = (u * pd <= pt).long()
        a = torch.cumprod(accept, dim=1).sum(dim=1)          # 0..K-1
        pd_res = pd_full.clone()
        pd_res[:, K - 1] = 0.0
        pick = a[:, None, None].expand(B, 1, V)
        pt_a = pt_full.gather(1, pick)[:, 0]
        res = (pt_a - pd_res.gather(1, pick)[:, 0]).clamp_min(0.0)
        norm = res.sum(dim=-1, keepdim=True)
        res = torch.where(norm > 0, res / torch.where(norm > 0, norm, 1.0),
                          pt_a)
        corr = self._draw(res, gen)
        q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
        ar = torch.arange(K, device=self.device)
        return a, torch.where(ar[None, :] < a[:, None], q_pad, corr[:, None])

    @staticmethod
    def _draw(probs: torch.Tensor, gen) -> torch.Tensor:
        """One categorical draw a row from (B, V) probabilities."""
        return torch.multinomial(probs, 1, generator=gen)[:, 0]


__all__: List[str] = ["SpeculativeDecoder"]
