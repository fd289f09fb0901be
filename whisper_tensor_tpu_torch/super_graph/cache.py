"""SuperGraph caches.

Reference equivalent: src/super_graph/cache.rs:11-36 —
SuperGraphCache (per-model-hash token-prefix -> RNN/KV state map with
longest-prefix resume) and SuperGraphTensorCache (loaded-weight cache).

The port's copy of whisper_tensor_tpu/super_graph/cache.py, unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class SuperGraphCache:
    """State cache keyed (model_hash, token prefix) with longest-prefix
    lookup — the inference-resume mechanism for chat sessions."""

    def __init__(self, max_entries_per_model: int = 32):
        self._store: Dict[int, Dict[Tuple[int, ...], Any]] = {}
        self.max_entries = max_entries_per_model

    def read(self, model_hash: int, tokens: Tuple[int, ...]
             ) -> Tuple[Tuple[int, ...], Optional[Any]]:
        """Longest stored prefix of `tokens` -> (prefix, state)."""
        entries = self._store.get(model_hash)
        if not entries:
            return (), None
        best: Tuple[int, ...] = ()
        for prefix in entries:
            if len(prefix) > len(best) and len(prefix) <= len(tokens) \
                    and tokens[:len(prefix)] == prefix:
                best = prefix
        if not best:
            return (), None
        return best, entries[best]

    def write(self, model_hash: int, tokens: Tuple[int, ...], state: Any) -> None:
        entries = self._store.setdefault(model_hash, {})
        entries[tuple(tokens)] = state
        while len(entries) > self.max_entries:
            # evict the shortest prefix (least useful for resume)
            victim = min(entries, key=len)
            del entries[victim]

    def clear(self) -> None:
        self._store.clear()


class SuperGraphTensorCache:
    """Per-store loaded/uploaded weight cache (reference cache.rs:28)."""

    def __init__(self):
        self._by_store: Dict[int, Dict[str, Any]] = {}

    def get(self, store_id: int) -> Dict[str, Any]:
        return self._by_store.setdefault(store_id, {})

    def clear(self) -> None:
        self._by_store.clear()
