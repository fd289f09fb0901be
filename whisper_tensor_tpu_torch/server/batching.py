"""Continuous batching on PyTorch: many concurrent generate requests share
one batched decode with per-row KV-cache positions.

Counterpart of whisper_tensor_tpu/server/batching.py:70-1415, with the
same constructor, `submit`, `cancel`, `drain`, `start`/`stop` and
`stats()` keys, which the port's server (`_batcher`, `_score_iface`,
`_generate_text_ragged`, the OpenAI front end, `GET /metrics`) uses as
the reference's server uses the reference batcher. Each request
occupies a SLOT (row) of a persistent batched KV cache. Admissions
prefill in power-of-two groups at a bucketed length into fresh k-row
caches, which are spliced into the slots; all rows then advance
together through a `chunk`-step decode (per-row positions via the
pos_per_row step graph). Idle rows park at the reserved position
max_len - 1.

The loop is PIPELINED as in the reference: row state (cur, pos, active)
stays on the device between chunks, slot updates queued on the host
(admissions, parks) apply at the next dispatch, and the host waits for
chunk k's tokens only after chunk k+1 is enqueued. In PyTorch that means:
  * uploads go through pinned memory without waiting for the device
    (dtype.host_to_device); nothing in a chunk or a pipelined admission
    reads a device value on the host;
  * each chunk's tokens, flags and positions are copied into pinned host
    tensors with non_blocking=True right after the chunk is enqueued, a
    CUDA event is recorded, and the host waits on that event in the
    next tick, after the next chunk is enqueued;
  * a pipelined admission's first tokens stay on the device; their host
    copy is enqueued before the chunk that carries them, so that chunk's
    event covers it.
The slot updates have their exact length: eager PyTorch has no fixed
program shape, so the reference's out-of-range pad index (`mode="drop"`
scatters, batching.py:663-667) has no counterpart.

Differences from the reference, each for a reason:
  * no JIT program cache and no background AOT compile of the adaptive
    ladder's chunk lengths (`_programs`, `_chunk_runner`/`_chunk_exec`,
    :709-758): eager PyTorch compiles nothing, so every ladder length is
    ready at once. The ladder's choice of length (`_pick_chunk_len`)
    stays: it sets how often the host waits for the device;
  * `max_batch` is not rounded up to a power of two (:177-184): that
    avoids an XLA tiling cliff measured on v5e, which no H100 measurement
    has asked for; `stats()["slots"]` is the configured count;
  * no WT_BATCH_TRACE event timeline.

Multi-LoRA serving is the reference's (`adapters=`, `submit(adapter=)`,
:172-175, :266-290): each row's adapter slot (0 = base) is kept on the
host in `_row_lora` and uploaded as a (B,) int64 tensor when it
changes, at admission and at a slot's release. A decode chunk, an
admission group or a prefill piece in which every row is base runs the
interface's pre-surgery graph (the reference's `la=False` variants);
any adapted row runs the adapted graph with the rows' slots. The shared
prefix is prefilled once per adapter, and the auto-prefix pool is keyed
by (adapter slot, tokens), so a prefix's KV is always computed under the
request's own adapter.

Window admission is the reference's (:464-500): where the interface
carries a step graph built at max_len == bucket (window_models, which
rule adapters out) and no prefix is configured or matched, a k-row
admission prefills into `window_cache_dims(k, bucket)` caches, k x
bucket instead of k x max_len, and writes them into positions
[0, bucket) of the slots. Positions at or past the bucket keep the
previous tenant's keys and values, hidden by the position mask until
decode overwrites them (decode writes a position before it reads it).

Two faults of the reference are repaired here (ROADMAP C):
  * a prompt longer than the largest prompt bucket under prefill_chunk
    is prefilled in pieces; the reference's `_advance_admission`
    (:989-990) buckets it first and fails the whole tick;
  * under prefill_chunk, a slot that an idle batcher freed still holds
    its previous tenant's queued park when a chunked admission reserves
    it; the reference applies that park as the new tenant's first
    dispatch (:1276-1280) and drains the parked row's token as the
    request's whole answer. Here the park applies, but the tenant counts
    as dispatched only once its admission installs it.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..dtype import DType, host_to_device
from ..interfaces.text import (SamplingParams, TextInferenceInterface,
                               _bucket, _fold, _mix32, _pick_token_rows,
                               _rows_flags, rows_tensors)
from ..model import Model


@dataclass
class _Request:
    prompt_ids: np.ndarray
    n_new: int
    future: Future = field(default_factory=Future)
    on_token: Optional[Any] = None       # callback(token_id) for streaming
    cancelled: threading.Event = field(default_factory=threading.Event)
    # per-request sampling: None = the batcher default
    sampling: Optional[SamplingParams] = None
    # arrival time (admission-coalescing deadline)
    t_arrival: float = field(default_factory=time.time)
    # LoRA adapter name (multi-LoRA serving): None = base
    adapter: Optional[str] = None


@dataclass
class _Slot:
    req: Optional[_Request] = None
    emitted: List[int] = field(default_factory=list)
    # index of the first decode chunk that includes this request (its
    # admission update rides in with that chunk's dispatch); None until
    # dispatched: earlier chunks' rows for this slot belong to a
    # previous tenant and must not be emitted
    dispatched: Optional[int] = None
    # pipelined admission: (group dict, row) holding this row's first
    # token on the device, read at the drain of `dispatched`
    first_group: Optional[tuple] = None


class ContinuousBatcher:
    """model must be built with pos_per_row=True (per-row `pos` input).

    Sampling is per request (submit(..., sampling=...)): every knob is a
    per-row tensor of one batched pick (interfaces/text.py
    _pick_token_rows), so greedy and sampled requests batch together.
    The constructor `sampling` is the default for requests that pass
    none. See the reference's docstring (whisper_tensor_tpu/server/
    batching.py:99-162) for prefill_chunk, prefix_ids, chunk_max,
    admit_coalesce_s, auto_prefix, iface and max_admit; they mean the
    same here. `device` is the torch device of a batcher that builds its
    own interface."""

    def __init__(self, model: Optional[Model], max_len: int,
                 max_batch: int = 8, chunk: int = 16,
                 cache_dtype: DType = DType.BF16,
                 prompt_buckets: Sequence[int] = (16, 32, 64, 128, 256),
                 eos_token_id=None,
                 sampling: Optional[SamplingParams] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_ids: Optional[np.ndarray] = None,
                 quantize: Optional[str] = None,
                 adapters=None,
                 chunk_max: Optional[int] = None,
                 admit_coalesce_s: float = 0.05,
                 auto_prefix: int = 0,
                 iface: Optional[TextInferenceInterface] = None,
                 max_admit: Optional[int] = None,
                 device=None):
        if iface is not None:
            if iface.max_len != max_len:
                raise ValueError(
                    f"shared iface max_len {iface.max_len} != {max_len}")
            self.iface = iface
        else:
            self.iface = TextInferenceInterface(
                model, max_len=max_len, cache_dtype=cache_dtype,
                prompt_buckets=prompt_buckets, quantize=quantize,
                device=device)
        if self.iface.logits_last_only:
            # admission reads each row's own last position, a chunked
            # prefill's a piece's
            raise self.iface._last_only_refusal("the batcher's admission")
        if adapters:
            # per-row adapter selection: submit(..., adapter=<name>)
            self.iface.install_adapters(adapters)
        self.device = self.iface.device
        self.max_len = max_len
        self.max_batch = max_batch
        self.max_admit = max_admit
        self.chunk = chunk
        self.chunk_max = (None if chunk_max is None or chunk_max <= chunk
                          else int(chunk_max))
        # int or list (HF checkpoints may declare several end tokens);
        # eos_token_id stays the primary id, eos_token_ids the full set
        if eos_token_id is None or isinstance(eos_token_id, int):
            self.eos_token_id = eos_token_id
            self.eos_token_ids = (None if eos_token_id is None
                                  else (eos_token_id,))
        else:
            ids = tuple(int(e) for e in eos_token_id)
            self.eos_token_id = ids[0] if ids else None
            self.eos_token_ids = ids or None
        self._eos = (None if self.eos_token_ids is None else torch.tensor(
            self.eos_token_ids, dtype=torch.int64, device=self.device))
        self.sampling = sampling
        # the key every sampled draw derives from (the reference's
        # PRNGKey(sampling.seed or 0))
        self._key = _mix32((sampling.seed if sampling else 0) & 0xFFFFFFFF)
        self.park_pos = max_len - 1       # reserved scratch slot position
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._requests: Dict[Future, _Request] = {}   # for cancel()
        self._slots = [_Slot() for _ in range(max_batch)]
        # each slot's adapter (0 = base) on the host, and its last
        # upload: (host values, (B,) int64 device tensor)
        self._row_lora = np.zeros(max_batch, np.int64)
        self._row_lora_dev = (None, None)
        self._caches: Optional[List[torch.Tensor]] = None
        # row state (chunk count, cur token, position, active) lives ON
        # THE DEVICE between chunks; the host queues slot updates
        # (admissions, parks) that the next dispatch applies
        self._pending: Dict[int, tuple] = {}   # slot -> (cur, pos, active)
        self._row_state = None
        self._rows = (None, None)          # (SamplingParams per slot, tensors)
        self._seen: Optional[torch.Tensor] = None   # (B, V) penalty counts
        self.prefill_chunk = prefill_chunk
        self._admission: Optional[dict] = None   # in-flight chunked prefill
        self._admit_backlog: List[tuple] = []    # (slot, req) not yet started
        self._chunks_dispatched = 0
        self._tokens_emitted = 0
        self.admit_coalesce_s = admit_coalesce_s
        self._wait: List[_Request] = []   # arrived, not yet admitted
        # wall-clock accumulators per scheduler phase, seconds
        self._t_admit = 0.0      # prefill dispatch + install
        self._t_dispatch = 0.0   # chunk enqueue
        self._t_fetch = 0.0      # blocking device->host waits
        self._steps_dispatched = 0
        # pipelined admissions: groups whose first tokens are still on
        # the device, waiting to ride into the next chunk dispatch
        self._dev_admits: List[dict] = []
        self.prefix_ids = (None if prefix_ids is None else
                           np.asarray(prefix_ids, np.int64).reshape(-1))
        self.prefix_len = 0 if self.prefix_ids is None \
            else int(self.prefix_ids.shape[0])
        # adapter slot -> the prefix's KV rows computed under it
        self._prefix_caches: Dict[int, List[torch.Tensor]] = {}
        self.auto_prefix = int(auto_prefix)
        if self.auto_prefix and self.prefix_ids is not None:
            raise ValueError("auto_prefix and prefix_ids are exclusive")
        # (adapter slot, key bytes) -> {caches, plen, used}; LRU by `used`
        self._auto_pool: Dict[Any, dict] = {}
        self._auto_clock = 0
        self._auto_hits = 0
        self._auto_misses = 0
        self._pieces_run = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._wake = threading.Event()

    # -- public API --------------------------------------------------------
    def submit(self, prompt_ids: np.ndarray, n_new: int,
               on_token=None,
               sampling: Optional[SamplingParams] = None,
               adapter: Optional[str] = None) -> Future:
        if adapter is not None and \
                adapter not in self.iface.adapter_slots:
            raise ValueError(
                f"unknown adapter {adapter!r} "
                f"(loaded: {[n for n in self.iface.adapter_slots if n]})")
        req = _Request(np.asarray(prompt_ids, np.int64).reshape(-1), n_new,
                       on_token=on_token, sampling=sampling, adapter=adapter)
        self._requests[req.future] = req
        self._queue.put(req)
        self._wake.set()
        return req.future

    def _adapter_slot(self, req: _Request) -> int:
        return self.iface.adapter_slots.get(req.adapter, 0)

    def _lora_rows(self, slots) -> Optional[torch.Tensor]:
        """The (k,) int64 adapter slots of a group of rows on the device,
        or None when every row is base (the pre-surgery graph runs)."""
        if not any(slots):
            return None
        return self._upload(np.asarray(slots, np.int64))

    def stats(self) -> dict:
        """Live scheduler snapshot: slot occupancy, queue depth,
        emitted-token and chunk counters (the reference's keys)."""
        active = sum(1 for s in self._slots if s.req is not None)
        return {"slots": self.max_batch, "active": active,
                "queued": self._queue.qsize() + len(self._wait)
                + len(self._admit_backlog),
                "admitting": self._admission is not None,
                "chunks_dispatched": self._chunks_dispatched,
                "steps_dispatched": self._steps_dispatched,
                "tokens_emitted": self._tokens_emitted,
                "time_admit_s": round(self._t_admit, 3),
                "time_dispatch_s": round(self._t_dispatch, 3),
                "time_fetch_s": round(self._t_fetch, 3),
                "prefix_len": self.prefix_len,
                "auto_prefix": {"pool": len(self._auto_pool),
                                "hits": self._auto_hits,
                                "misses": self._auto_misses}
                if self.auto_prefix else None,
                "prefill_chunk": self.prefill_chunk,
                "chunk": self.chunk,
                "chunk_max": self.chunk_max}

    def cancel(self, future: Future) -> bool:
        """Cancel a submitted request. A request not yet in a slot
        resolves at once with zero tokens; a running request resolves
        with the tokens emitted so far at the next scheduler tick, and
        its slot frees. False for unknown or finished futures."""
        req = self._requests.get(future)
        if req is None or future.done():
            return False
        req.cancelled.set()
        in_slot = any(s.req is req for s in self._slots)
        adm = self._admission
        in_adm = adm is not None and any(r is req for _, r in adm["grp"])
        if not in_slot and not in_adm:
            if not future.done():
                future.set_result(np.zeros(0, np.int64))
            self._requests.pop(future, None)
        self._wake.set()
        return True

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def drain(self, timeout: float = 600.0) -> bool:
        """Wait until every accepted request has finished, then stop.
        Idleness is judged by the scheduler thread between ticks (see the
        reference, batching.py:354-378). On timeout the batcher
        force-stops and every outstanding future gets a TimeoutError."""
        self._draining.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        clean = t is None or not t.is_alive()
        if not clean:
            self.stop()
        for req in list(self._requests.values()):
            if not req.future.done():
                req.future.set_exception(TimeoutError(
                    "batcher drained with the request outstanding"))
        self._thread = None
        return clean

    # -- device <-> host ------------------------------------------------------
    def _upload(self, arr) -> torch.Tensor:
        return host_to_device(np.asarray(arr), self.device)

    def _fetch_async(self, tensors):
        """Start copying device tensors to the host: (host tensors, CUDA
        event to wait on, or None on the CPU)."""
        if self.device.type == "cpu":
            return list(tensors), None
        hosts = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            hosts.append(h)
        ev = torch.cuda.Event()
        ev.record()
        return hosts, ev

    # -- per-row sampling helpers -------------------------------------------
    def _slot_sp(self, slot: _Slot) -> Optional[SamplingParams]:
        """Effective SamplingParams for a slot's tenant (its own, else
        the batcher default); None (greedy) for empty slots."""
        if slot.req is None:
            return None
        return slot.req.sampling or self.sampling

    def _rows_for(self, sps):
        """The per-row sampling tensors, uploaded again only when a
        slot's parameters changed."""
        key = tuple(sps)
        if self._rows[0] != key:
            self._rows = (key, rows_tensors(sps, self.device))
        return self._rows[1]

    def _ensure_seen(self) -> torch.Tensor:
        """The (B, V) per-row token-occurrence counts behind the
        repetition / presence / frequency penalties, on the device.
        Rows whose params are neutral never read it, so counts left by
        earlier tenants are harmless."""
        if self._seen is None:
            self._seen = torch.zeros(
                (self.max_batch, self.iface._vocab_size()), dtype=torch.int32,
                device=self.device)
        return self._seen

    def _prompt_counts(self, grp) -> np.ndarray:
        """(k, V) counts of each request's prefix + prompt tokens."""
        V = self.iface._vocab_size()
        cnt = np.zeros((len(grp), V), np.int32)
        for r, (_, req) in enumerate(grp):
            ids = req.prompt_ids
            if self.prefix_ids is not None:
                ids = np.concatenate([self.prefix_ids, ids])
            np.add.at(cnt[r], np.clip(ids, 0, V - 1), 1)
        return cnt

    def _first_tokens(self, grp, last) -> np.ndarray:
        """Admission-time first token of each admitted row, with every
        per-request sampling knob; read back on the host (the
        reference's synchronous admission tail)."""
        sps = [req.sampling or self.sampling for _, req in grp]
        flags = _rows_flags(sps)
        rows = rows_tensors(sps, self.device)
        cnt = self._prompt_counts(grp) if flags[4] else None
        seen = None if cnt is None else self._upload(cnt)
        firsts = _pick_token_rows(last, self._key, rows, flags,
                                  seen).cpu().numpy()
        if cnt is not None:
            # seed the admitted rows' counts: prompt + first token
            cnt[np.arange(len(grp)), firsts] += 1
            slots = self._upload([s for s, _ in grp])
            self._ensure_seen()[slots] = self._upload(cnt)
        return firsts

    # -- admission ------------------------------------------------------------
    def _ensure_prefix(self, adapter_slot: int = 0) -> List[torch.Tensor]:
        """Prefill the shared prefix once per adapter (B=1) and keep its
        KV rows; admissions start from copies of them. An adapter
        request's prefix KV is computed under that adapter, as a plain
        prefix + prompt run of the adapted model computes it."""
        cached = self._prefix_caches.get(adapter_slot)
        if cached is None:
            sb = _bucket(self.prefix_len, self.iface.prompt_buckets)
            padded = np.zeros((1, sb), np.int64)
            padded[0, :self.prefix_len] = self.prefix_ids
            cached = self.iface.fresh_cache(1)
            self.iface.step(self._upload(padded),
                            torch.zeros(1, dtype=torch.int64,
                                        device=self.device), cached,
                            self._lora_rows([adapter_slot]))
            self._prefix_caches[adapter_slot] = cached
        return cached

    def _prefix_small(self, k: int, gidx) -> List[torch.Tensor]:
        """k-row admission caches: copies of the prefix KV, each row from
        its adapter's (fresh zeros when no prefix is configured). The
        copies are the admission prefill's to write into, never the
        shared prefix."""
        if self.prefix_ids is None:
            return self.iface.fresh_cache(k)
        if len(set(gidx)) == 1:
            return [c.repeat(k, 1, 1, 1) for c in self._ensure_prefix(gidx[0])]
        per_row = [self._ensure_prefix(a) for a in gidx]
        return [torch.cat([pr[i] for pr in per_row])
                for i in range(len(per_row[0]))]

    def _splice(self, small, slots: torch.Tensor) -> None:
        """Write an admission's k cache rows into the batched caches at
        `slots`, in place; window caches (a window admission) into the
        first positions of the slots' rows."""
        for big, s in zip(self._caches, small):
            if s.shape[2:] != big.shape[2:]:
                big = big[:, :, :s.shape[2]]
            big.index_copy_(0, slots, s.to(big.dtype))

    def _admit_window(self, bucket: int) -> Optional[int]:
        """The window a no-prefix admission at `bucket` prefills in: the
        bucket itself, where the interface has a step graph at that
        max_len below the slots' (window_models; such an interface takes
        no adapters); else None."""
        if (self.prefix_ids is None and bucket < self.max_len
                and bucket in self.iface._window_millis):
            return bucket
        return None

    def _match_auto_prefix(self, req: _Request):
        """Longest pool entry of the request's adapter whose tokens
        strictly prefix the prompt -> (plen, entry) or (0, None)."""
        ids = req.prompt_ids
        L = ids.shape[0]
        aslot = self._adapter_slot(req)
        best, best_plen = None, 0
        for (a, kb), e in self._auto_pool.items():
            if a != aslot or e["plen"] <= best_plen or e["plen"] >= L:
                continue
            if ids[:e["plen"]].tobytes() == kb:
                best, best_plen = e, e["plen"]
        if best is not None:
            self._auto_clock += 1
            best["used"] = self._auto_clock
        return best_plen, best

    def _slice_row(self, slot_idx: int) -> List[torch.Tensor]:
        """A copy of one slot's cache rows: the slot's next tenant
        overwrites the rows, the pool entry must keep them."""
        return [c[slot_idx:slot_idx + 1].clone() for c in self._caches]

    def _store_auto_entries(self, grp, gidx):
        """Deposit each admitted prompt's 32-aligned prefix KV row into
        the pool (LRU-capped), keyed by its adapter."""
        for (slot_idx, req), a in zip(grp, gidx):
            pk = 32 * (int(req.prompt_ids.shape[0]) // 32)
            if pk < 32:
                continue
            key = (a, req.prompt_ids[:pk].tobytes())
            self._auto_clock += 1
            if key in self._auto_pool:
                self._auto_pool[key]["used"] = self._auto_clock
                continue
            self._auto_pool[key] = {
                "caches": self._slice_row(slot_idx), "plen": pk,
                "used": self._auto_clock}
            while len(self._auto_pool) > self.auto_prefix:
                victim = min(self._auto_pool,
                             key=lambda kk: self._auto_pool[kk]["used"])
                del self._auto_pool[victim]

    def _admit_group(self, pairs):
        """pairs: [(slot_idx, req)]; partitioned by matched auto-prefix
        entry (rows of one prefill share one position offset), then
        admitted in power-of-2 sub-groups."""
        if not (self.auto_prefix and self.prefix_ids is None):
            self._admit_part(pairs, self.prefix_len, None)
            return
        tagged = []
        for sp in pairs:
            plen, entry = self._match_auto_prefix(sp[1])
            if entry is not None:
                self._auto_hits += 1
            else:
                self._auto_misses += 1
            tagged.append((plen, id(entry), sp, entry))
        tagged.sort(key=lambda t: (t[0], t[1],
                                   t[2][1].prompt_ids.shape[0]))
        i = 0
        while i < len(tagged):
            j = i
            while j < len(tagged) and tagged[j][:2] == tagged[i][:2]:
                j += 1
            self._admit_part([t[2] for t in tagged[i:j]], tagged[i][0],
                             tagged[i][3])
            i = j

    def _admit_part(self, pairs, plen: int, entry: Optional[dict]):
        """One seed partition: prefill the remainders at pos=plen from
        the entry's (or the configured prefix's, or zero) KV, splice the
        rows into their slots, and pick each row's first token."""
        # auto-prefix rows feed only the remainder tokens; a configured
        # prefix's prompts already exclude the prefix
        cut = plen if entry is not None else 0
        i = 0
        k_cap = min(self.max_batch, self.max_admit or self.max_batch)
        while i < len(pairs):
            k = 1
            while k * 2 <= len(pairs) - i and k * 2 <= k_cap:
                k *= 2
            grp = pairs[i:i + k]
            i += k
            Sb = _bucket(max(r.prompt_ids.shape[0] - cut for _, r in grp),
                         self.iface.prompt_buckets)
            padded = np.zeros((k, Sb), np.int64)
            lens = []
            for row, (_, req) in enumerate(grp):
                rem = req.prompt_ids[cut:]
                padded[row, :rem.shape[0]] = rem
                lens.append(rem.shape[0])
            gidx = [self._adapter_slot(r) for _, r in grp]
            for (s, _), a in zip(grp, gidx):
                self._row_lora[s] = a
            win = None if entry is not None else self._admit_window(Sb)
            if entry is not None:
                small = [c.repeat(k, 1, 1, 1) for c in entry["caches"]]
            elif win is not None:
                small = [torch.zeros(d, dtype=self._caches[0].dtype,
                                     device=self.device)
                         for d in self.iface.window_cache_dims(k, win)]
            else:
                small = self._prefix_small(k, gidx)
            meta = self._upload([[s for s, _ in grp], [L - 1 for L in lens]])
            logits = self.iface.step(
                self._upload(padded),
                torch.full((k,), plen, dtype=torch.int64, device=self.device),
                small, self._lora_rows(gidx), window=win)
            self._splice(small, meta[0])
            del small
            if self.auto_prefix:
                self._store_auto_entries(grp, gidx)
            last = logits[torch.arange(k, device=self.device), meta[1]]
            del logits
            sps = [req.sampling or self.sampling for _, req in grp]
            flags = _rows_flags(sps)
            if flags[4]:
                # penalty rows need their counts seeded on the host: the
                # synchronous admission, as in the reference
                self._install_admitted(grp, [plen + L for L in lens],
                                       self._first_tokens(grp, last))
                continue
            # PIPELINED admission: the first token stays on the device,
            # rides into the next chunk dispatch, and is read with that
            # chunk's fetch: no device->host wait here
            rows = rows_tensors(sps, self.device) if flags[0] else None
            firsts = _pick_token_rows(last, self._key, rows, flags)
            act = self._upload([req.n_new > 1 for _, req in grp])
            if self._eos is not None:
                act = act & ~(firsts[:, None] == self._eos).any(dim=1)
            hosts, _ = self._fetch_async((firsts,))
            ga = {"slots": [s for s, _ in grp], "firsts": firsts,
                  "active": act, "host": hosts[0],
                  "pos": [min(plen + L, self.park_pos) for L in lens]}
            for row, (slot_idx, req) in enumerate(grp):
                slot = self._slots[slot_idx]
                slot.req = req
                slot.emitted = []
                slot.dispatched = None
                slot.first_group = (ga, row)
                # an older queued park for this slot (its previous
                # tenant's _finish) is subsumed: the admission sets
                # cur/pos/active itself and must win
                self._pending.pop(slot_idx, None)
            self._dev_admits.append(ga)

    def _install_admitted(self, grp, lens, firsts):
        """Common admission tail: record each row's first token, queue
        its slot update, and retire single-token/EOS requests."""
        for row, (slot_idx, req) in enumerate(grp):
            slot = self._slots[slot_idx]
            if req.cancelled.is_set() or req.future.done():
                # cancelled while its admission was in flight: resolve
                # with nothing emitted, park the (already written) slot
                slot.req = req
                slot.emitted = []
                slot.dispatched = None
                self._finish(slot_idx)
                continue
            first = int(firsts[row])
            slot.req = req
            slot.emitted = [first]
            slot.dispatched = None
            self._tokens_emitted += 1
            if req.on_token is not None:
                req.on_token(first)
            eos_hit = (self.eos_token_ids is not None
                       and first in self.eos_token_ids)
            self._pending[slot_idx] = (
                first, min(int(lens[row]), self.park_pos),
                not eos_hit and req.n_new > 1)
            if req.n_new <= 1 or eos_hit:
                self._finish(slot_idx)

    def _advance_admission(self):
        """Chunked-prefill admission: start a group when idle, then run
        ONE prefill piece per tick; on the last piece, splice the group's
        caches into the batched cache and install the rows. Decode chunks
        of running rows dispatch in the same ticks."""
        W = self.prefill_chunk
        if self._admission is None:
            for i, slot in enumerate(self._slots):
                if slot.req is None and all(s != i for s, _ in
                                            self._admit_backlog):
                    try:
                        req = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if req.cancelled.is_set():
                        if not req.future.done():
                            req.future.set_result(np.zeros(0, np.int64))
                        self._requests.pop(req.future, None)
                        continue
                    self._requests.setdefault(req.future, req)
                    self._admit_backlog.append((i, req))
            if not self._admit_backlog:
                return
            # FIFO: the oldest pow-2 group
            k = 1
            while (k * 2 <= len(self._admit_backlog)
                   and k * 2 <= self.max_batch):
                k *= 2
            grp = self._admit_backlog[:k]
            self._admit_backlog = self._admit_backlog[k:]
            max_l = max(r.prompt_ids.shape[0] for _, r in grp)
            if (max_l <= self.iface.prompt_buckets[-1]
                    and _bucket(max_l, self.iface.prompt_buckets) <= W):
                # short group: the whole-bucket path is one small prefill
                try:
                    self._admit_group(grp)
                except Exception as e:  # noqa: BLE001
                    for _, req in grp:
                        if not req.future.done():
                            req.future.set_exception(e)
                return
            n_pieces = -(-max_l // W)
            padded = np.zeros((k, n_pieces * W), np.int64)
            lens = np.zeros(k, np.int64)
            for row, (i, req) in enumerate(grp):
                L = req.prompt_ids.shape[0]
                padded[row, :L] = req.prompt_ids
                lens[row] = self.prefix_len + L   # absolute position
                # reserve the slot (dispatched stays None, so drains
                # skip it and decode updates don't touch it)
                self._slots[i].req = req
                self._slots[i].emitted = []
                self._slots[i].dispatched = None
            gidx = [self._adapter_slot(r) for _, r in grp]
            for (s, _), a in zip(grp, gidx):
                self._row_lora[s] = a
            self._admission = dict(
                grp=grp, k=k, piece=0, n=n_pieces, padded=padded, lens=lens,
                lora=self._lora_rows(gidx),
                flg=torch.zeros((k, self.iface._vocab_size()),
                                dtype=torch.float32, device=self.device),
                small=self._prefix_small(k, gidx))
        st = self._admission
        j = st["piece"]
        off = self.prefix_len + j * W
        logits = self.iface.step(
            self._upload(st["padded"][:, j * W:(j + 1) * W]),
            torch.full((st["k"],), off, dtype=torch.int64,
                       device=self.device), st["small"], st["lora"])
        # rows whose last prompt token falls in this piece keep its
        # logits (known on the host: no device-side select)
        idx = st["lens"] - 1 - off
        hit = np.nonzero((idx >= 0) & (idx < W))[0]
        if hit.size:
            sel = self._upload([hit, idx[hit]])
            st["flg"][sel[0]] = logits[sel[0], sel[1]].float()
        del logits
        self._pieces_run += 1
        st["piece"] += 1
        if st["piece"] < st["n"]:
            return
        self._admission = None
        self._splice(st["small"], self._upload([s for s, _ in st["grp"]]))
        firsts = self._first_tokens(st["grp"], st["flg"])
        self._install_admitted(st["grp"], st["lens"], firsts)

    # -- scheduler loop ------------------------------------------------------
    def _finish(self, slot_idx: int):
        slot = self._slots[slot_idx]
        req = slot.req
        if req is not None and not req.future.done():
            req.future.set_result(np.asarray(slot.emitted[:req.n_new],
                                             np.int64))
        if req is not None:
            self._requests.pop(req.future, None)
        slot.req = None
        slot.emitted = []
        slot.dispatched = None
        slot.first_group = None
        self._row_lora[slot_idx] = 0
        # park the device row at the next dispatch (harmless if it keeps
        # decoding for one in-flight chunk first: its writes land at
        # positions no future tenant reads below its own pos)
        self._pending[slot_idx] = (0, self.park_pos, False)

    def _loop(self):
        """Pipelined scheduler: dispatch chunk k+1 before waiting for
        chunk k's tokens. A tick failure fails every outstanding future
        with the cause and resets to an empty state, then keeps
        serving."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        inflight = None                  # (chunk index, host tensors, event)
        while not self._stop.is_set():
            if (self._draining.is_set() and inflight is None
                    and all(s.req is None for s in self._slots)
                    and self._queue.empty() and not self._wait
                    and self._admission is None
                    and not self._admit_backlog):
                # drain(): judged here, between ticks, where no request
                # can be hiding in _tick locals
                return
            try:
                inflight = self._tick(inflight)
            except Exception as e:  # noqa: BLE001 -- keep serving
                # every request outstanding at the failure, taken before
                # any future fails: a caller woken by its failed future
                # may submit again at once, and that request is served
                failed = [s.req for s in self._slots if s.req is not None]
                for slot in self._slots:
                    slot.req = None
                    slot.emitted = []
                    slot.dispatched = None
                    slot.first_group = None
                while True:
                    try:
                        failed.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
                failed += [req for _, req in self._admit_backlog]
                failed += self._wait
                for req in failed:
                    if not req.future.done():
                        req.future.set_exception(e)
                self._wait = []
                self._dev_admits = []
                self._admit_backlog = []
                self._admission = None
                self._pending = {}
                self._requests = {}
                # a failed tick may have left the caches half written:
                # rebuild row state and caches on the next tick
                self._caches = None
                self._row_state = None
                self._seen = None
                self._rows = (None, None)
                self._row_lora[:] = 0
                inflight = None

    def _pick_chunk_len(self, inflight) -> int:
        """Adaptive chunk length (chunk_max): the largest power-of-two
        multiple of `chunk` (capped at chunk_max) that every live row
        verifiably still needs, counting the in-flight chunk against
        each row; long chunks only when nothing is mid-admission and no
        waiting request could take a slot during them (reference
        batching.py:1117-1157)."""
        if self.chunk_max is None:
            return self.chunk
        if self._admit_backlog or self._admission is not None:
            return self.chunk
        if not self._queue.empty() or self._wait:
            if self.eos_token_ids is not None \
                    or any(s.req is None for s in self._slots):
                return self.chunk
        pending_lag = inflight[1][0].shape[1] if inflight is not None else 0
        min_remaining = self.chunk_max
        for slot in self._slots:
            if slot.req is None:
                continue
            # a pipelined admission's first token is not in emitted yet
            first_pending = 1 if slot.first_group is not None else 0
            remaining = (slot.req.n_new - len(slot.emitted)
                         - pending_lag - first_pending)
            if remaining < min_remaining:
                min_remaining = remaining
        n = self.chunk
        while n * 2 <= min_remaining and n * 2 <= self.chunk_max:
            n *= 2
        return n

    def _drain_arrivals(self):
        """Move queued arrivals into the host-side wait list (dropping
        cancelled ones), so the admission policy can see ages and
        counts."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req.cancelled.is_set():          # cancelled in queue
                if not req.future.done():
                    req.future.set_result(np.zeros(0, np.int64))
                self._requests.pop(req.future, None)
                continue
            # re-register: a tick-failure reset may have swapped the
            # registry while submit() was between its two statements
            self._requests.setdefault(req.future, req)
            self._wait.append(req)

    def _admit_now(self, free) -> bool:
        """Admission coalescing (admit_coalesce_s): admit when the
        waiters fill every free slot, the oldest waiter is past its
        deadline, or the device has no decode work."""
        kept = []
        for r in self._wait:
            if r.cancelled.is_set():            # cancelled while waiting
                if not r.future.done():
                    r.future.set_result(np.zeros(0, np.int64))
                self._requests.pop(r.future, None)
            else:
                kept.append(r)
        self._wait = kept
        if not self._wait:
            return False
        if self.admit_coalesce_s <= 0:
            return True
        if len(self._wait) >= len(free):
            return True
        if time.time() - self._wait[0].t_arrival >= self.admit_coalesce_s:
            return True
        return not any(slot.req is not None for slot in self._slots)

    def _chunk_lora(self) -> Optional[torch.Tensor]:
        """Every slot's adapter on the device, uploaded again only when a
        slot's adapter changed; None while every row is base."""
        if not self._row_lora.any():
            return None
        key = self._row_lora.tobytes()
        if self._row_lora_dev[0] != key:
            self._row_lora_dev = (key, self._upload(self._row_lora))
        return self._row_lora_dev[1]

    def _run_chunk(self, n_steps, cur, pos, active, rows, flags, seen,
                   key: int):
        """`n_steps` decode steps of every row: (cur, pos, active) after
        them, and the (B, n_steps) tokens and active flags. Parked and
        finished rows step too (their picks are masked by `active`),
        which keeps the batch shape fixed. A chunk with no adapted row
        runs the base graph."""
        toks, acts = [], []
        lora = self._chunk_lora()
        for i in range(n_steps):
            logits = self.iface.step(cur[:, None], pos, self._caches, lora)
            nxt = _pick_token_rows(logits[:, -1, :], _fold(key, i), rows,
                                   flags, seen)
            nxt = torch.where(active, nxt, cur)
            if flags[4]:
                seen.scatter_add_(1, nxt[:, None],
                                  active[:, None].to(seen.dtype))
            if self._eos is not None:
                active = active & ~(nxt[:, None] == self._eos).any(dim=1)
            pos = torch.where(active, (pos + 1).clamp(max=self.park_pos),
                              pos)
            cur = nxt
            toks.append(nxt)
            acts.append(active)
        return cur, pos, active, torch.stack(toks, 1), torch.stack(acts, 1)

    def _apply_slot_updates(self, step_count, cur, pos, active):
        """Queued slot updates (admissions, parks) into the row state,
        out of place (the in-flight chunk's fetch still reads the old
        tensors)."""
        slots = list(self._pending)
        # a slot reserved by the in-flight chunked admission may still
        # hold its previous tenant's park: that update is not the new
        # tenant's, which is dispatched once its admission installs it
        reserved = ({s for s, _ in self._admission["grp"]}
                    if self._admission is not None else set())
        if slots:
            upd = self._upload([slots] + [list(col) for col in
                                          zip(*self._pending.values())])
            cur = cur.index_put((upd[0],), upd[1])
            pos = pos.index_put((upd[0],), upd[2])
            active = active.index_put((upd[0],), upd[3].bool())
            for s in slots:
                slot = self._slots[s]
                if (slot.req is not None and slot.dispatched is None
                        and s not in reserved):
                    slot.dispatched = step_count
        self._pending = {}
        # pipelined admissions: first tokens are device tensors. A row is
        # live only while its slot still points at this group (a later
        # _finish, e.g. cancel during admission, clears first_group and
        # queues the winning park instead)
        for ga in self._dev_admits:
            keep = [r for r, sl in enumerate(ga["slots"])
                    if (self._slots[sl].first_group is not None
                        and self._slots[sl].first_group[0] is ga)]
            if not keep:
                continue
            upd = self._upload([[ga["slots"][r] for r in keep],
                                [ga["pos"][r] for r in keep], keep])
            firsts, act = ga["firsts"], ga["active"]
            if len(keep) != len(ga["slots"]):
                firsts, act = firsts[upd[2]], act[upd[2]]
            cur = cur.index_put((upd[0],), firsts)
            pos = pos.index_put((upd[0],), upd[1])
            active = active.index_put((upd[0],), act)
            for r in keep:
                slot = self._slots[ga["slots"][r]]
                if slot.req is not None:
                    slot.dispatched = step_count
        self._dev_admits = []
        return cur, pos, active

    def _tick(self, inflight):
        """One scheduler iteration: admit, dispatch, then wait for the
        previously dispatched chunk. Returns the new in-flight chunk."""
        mb = self.max_batch
        dev = self.device
        if self._caches is None:
            self._caches = self.iface.fresh_cache(mb)
        if self._row_state is None:
            self._row_state = (
                0,                                               # chunks
                torch.zeros(mb, dtype=torch.int64, device=dev),  # cur
                torch.full((mb,), self.park_pos, dtype=torch.int64,
                           device=dev),                          # pos
                torch.zeros(mb, dtype=torch.bool, device=dev))   # active
        step_count, dcur, dpos, dact = self._row_state
        # retire cancelled rows first: their future resolves with the
        # tokens emitted so far and the slot parks
        for i, slot in enumerate(self._slots):
            if (slot.req is not None and slot.req.cancelled.is_set()
                    and slot.dispatched is not None):
                self._finish(i)
        t0 = time.time()
        if self.prefill_chunk is not None:
            self._advance_admission()
        else:
            self._drain_arrivals()
            free = [i for i, slot in enumerate(self._slots)
                    if slot.req is None]
            if self._wait and free and self._admit_now(free):
                taken, self._wait = (self._wait[:len(free)],
                                     self._wait[len(free):])
                pairs = list(zip(free, taken))
                pairs.sort(key=lambda p: p[1].prompt_ids.shape[0])
                try:
                    self._admit_group(pairs)
                except Exception as e:  # noqa: BLE001
                    for _, req in pairs:
                        if not req.future.done():
                            req.future.set_exception(e)
        # both admission paths, chunked pieces included
        self._t_admit += time.time() - t0
        # a slot reserved by an in-flight chunked admission (dispatched
        # None, no pending update) is not decodable work; a pipelined
        # admission is: its update rides with the next dispatch
        work = bool(self._dev_admits) or any(
            s.req is not None
            and (s.dispatched is not None or i in self._pending)
            for i, s in enumerate(self._slots))
        new_inflight = None
        if work:
            dcur, dpos, dact = self._apply_slot_updates(step_count, dcur,
                                                        dpos, dact)
            # per-row sampling params for every slot (parked rows are
            # greedy; their picks are masked by `active`)
            sps = [self._slot_sp(s) for s in self._slots]
            flags = _rows_flags(sps)
            rows = self._rows_for(sps) if flags[0] or flags[4] else None
            seen = self._ensure_seen() if flags[4] else None
            n_steps = self._pick_chunk_len(inflight)
            t0 = time.time()
            dcur, dpos, dact, toks, actives = self._run_chunk(
                n_steps, dcur, dpos, dact, rows, flags, seen,
                _fold(self._key, step_count))
            self._t_dispatch += time.time() - t0
            new_inflight = (step_count,) + self._fetch_async(
                (toks, actives, dpos))
            step_count += 1
            self._chunks_dispatched += 1
            self._steps_dispatched += n_steps
        self._row_state = (step_count, dcur, dpos, dact)
        if inflight is not None:
            # ONE host wait per chunk, while the chunk just dispatched
            # keeps the device busy
            chunk_idx, hosts, ev = inflight
            t0 = time.time()
            if ev is not None:
                ev.synchronize()
            toks, actives_np, pos_np = (h.numpy() for h in hosts)
            self._t_fetch += time.time() - t0
            self._drain_chunk(chunk_idx, toks, actives_np, pos_np)
        elif not work and self._admission is None \
                and not self._admit_backlog and not self._wait:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
        return new_inflight

    def _drain_chunk(self, chunk_idx, toks, actives_np, pos_np):
        """Emit a fetched chunk's tokens and retire finished slots.

        Bookkeeping lags the device by one in-flight chunk: a row that
        reaches its n_new keeps decoding until its park update lands.
        Those extra tokens are dropped here; a tenant only reads
        positions below its own pos, all written by itself."""
        for i, slot in enumerate(self._slots):
            req = slot.req
            if req is None:
                continue
            if req.future.done():           # failed admission cleanup
                self._finish(i)
                continue
            if slot.dispatched is None or chunk_idx < slot.dispatched:
                # admitted after this chunk was dispatched: these rows
                # belong to the slot's previous tenant
                continue
            if slot.first_group is not None:
                # pipelined admission: this chunk carried the row's
                # admission, and its first token's host copy is done
                ga, row = slot.first_group
                slot.first_group = None
                first = int(ga["host"][row])
                slot.emitted.append(first)
                self._tokens_emitted += 1
                if req.on_token is not None:
                    req.on_token(first)
                eos_hit = (self.eos_token_ids is not None
                           and first in self.eos_token_ids)
                if req.n_new <= 1 or eos_hit:
                    self._finish(i)
                    continue
            was_active = True
            for j in range(toks.shape[1]):   # this chunk's actual length
                if not was_active or len(slot.emitted) >= req.n_new:
                    break
                tok = int(toks[i, j])
                slot.emitted.append(tok)
                self._tokens_emitted += 1
                if req.on_token is not None:
                    req.on_token(tok)
                was_active = bool(actives_np[i, j])
            if len(slot.emitted) >= req.n_new or not was_active \
                    or pos_np[i] >= self.park_pos:
                self._finish(i)


__all__ = ["ContinuousBatcher"]
