"""Tokenizers.

Reference equivalent: src/tokenizer.rs:16-126 (AnyTokenizer: HF
`tokenizers` from hub/local/in-memory JSON + RWKV World; encode/decode
trait). Here: HF tokenizers (baked-in Rust lib) via local file or JSON
string, the RWKV World trie tokenizer (vocab file), and a byte-level
fallback that needs no assets.

The port's copy of whisper_tensor_tpu/tokenizer.py.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional


# chat templating ------------------------------------------------------------
#
# HF-ecosystem checkpoints ship a jinja `chat_template` in
# tokenizer_config.json; rendering one turns a [{role, content}] message
# list into the model's prompt string. The reference has no chat layer
# (its CLI takes raw prompts) — this is serving-parity beyond it. The
# rendering environment mirrors transformers' (ImmutableSandboxed jinja,
# raise_exception/strftime_now globals, special-token variables) so a
# template renders byte-identically to tokenizer.apply_chat_template.

_CHATML_FALLBACK = (
    "{%- for message in messages %}"
    "{{- '<|im_start|>' + message['role'] + '\n' + message['content']"
    " + '<|im_end|>' + '\n' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}{{- '<|im_start|>assistant\n' }}"
    "{%- endif %}")


def render_chat_template(template: str, messages, *,
                         add_generation_prompt: bool = True,
                         **special_tokens) -> str:
    """Render a jinja chat template exactly like transformers does
    (sandboxed env, raise_exception / strftime_now helpers, special
    tokens as plain variables)."""
    from datetime import datetime

    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def _raise(message):
        raise ValueError(f"chat template error: {message}")

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)
    env.globals["raise_exception"] = _raise
    env.globals["strftime_now"] = lambda fmt: datetime.now().strftime(fmt)
    env.policies["json.dumps_kwargs"] = {"sort_keys": False,
                                         "ensure_ascii": False}
    return env.from_string(template).render(
        messages=messages, add_generation_prompt=add_generation_prompt,
        **special_tokens)


def apply_chat_template(tokenizer, messages, *,
                        add_generation_prompt: bool = True) -> str:
    """[{role, content}] -> prompt string using the tokenizer's own
    template when it has one, else the ChatML fallback."""
    template = getattr(tokenizer, "chat_template", None) or _CHATML_FALLBACK
    special = dict(getattr(tokenizer, "special_tokens", None) or {})
    special.setdefault("bos_token", "")
    special.setdefault("eos_token", "")
    return render_chat_template(template, messages,
                                add_generation_prompt=add_generation_prompt,
                                **special)


def _read_tokenizer_config(dir_path: str) -> dict:
    p = os.path.join(dir_path, "tokenizer_config.json")
    if not os.path.exists(p):
        return {}
    try:
        with open(p, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _attach_chat_config(tok, cfg: dict) -> None:
    """Hang chat_template + special token strings off a tokenizer."""
    template = cfg.get("chat_template")
    if isinstance(template, list):  # named-template list form
        named = {t.get("name"): t.get("template") for t in template
                 if isinstance(t, dict)}
        template = named.get("default") or next(iter(named.values()), None)
    tok.chat_template = template
    special = {}
    for k in ("bos_token", "eos_token", "unk_token", "pad_token"):
        v = cfg.get(k)
        if isinstance(v, dict):  # AddedToken serialized form
            v = v.get("content")
        if isinstance(v, str):
            special[k] = v
    tok.special_tokens = special


class ByteTokenizer:
    """Asset-free byte-level tokenizer: token = byte + 3 (0..2 reserved
    for pad/bos/eos)."""

    PAD, BOS, EOS = 0, 1, 2

    @property
    def vocab_size(self) -> int:
        return 259

    def encode(self, text: str) -> List[int]:
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        return bytes(i - 3 for i in ids if 3 <= i < 259).decode(
            "utf-8", errors="replace")


class HFTokenizer:
    def __init__(self, tok):
        self._tok = tok

    @staticmethod
    def from_file(path: str) -> "HFTokenizer":
        from tokenizers import Tokenizer

        return HFTokenizer(Tokenizer.from_file(path))

    @staticmethod
    def from_json(data: str) -> "HFTokenizer":
        from tokenizers import Tokenizer

        return HFTokenizer(Tokenizer.from_str(data))

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text).ids

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(list(ids))


class RwkvWorldTokenizer:
    """Greedy-longest-match trie tokenizer over the RWKV World vocab
    (reference rwkv-tokenizer crate). Vocab file lines:
    `<id> <python-repr-of-bytes-or-str> <length>`."""

    def __init__(self, vocab_path: Optional[str] = None):
        import ast

        self._id_to_bytes = {}
        self._trie = {}
        if vocab_path is None:
            return
        with open(vocab_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                idx_s, rest = line.split(" ", 1)
                payload_s, _len = rest.rsplit(" ", 1)
                token = ast.literal_eval(payload_s)
                if isinstance(token, str):
                    token = token.encode("utf-8")
                self._add(int(idx_s), token)

    @staticmethod
    def from_pieces(pieces: List[str]) -> "RwkvWorldTokenizer":
        """The same matcher over token strings given in id order."""
        tok = RwkvWorldTokenizer()
        for tid, piece in enumerate(pieces):
            tok._add(tid, piece.encode("utf-8"))
        return tok

    def _add(self, tid: int, token: bytes) -> None:
        self._id_to_bytes[tid] = token
        node = self._trie
        for byte in token:
            node = node.setdefault(byte, {})
        node[-1] = tid

    @property
    def vocab_size(self) -> int:
        return max(self._id_to_bytes) + 1

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        out, i = [], 0
        while i < len(data):
            node = self._trie
            best = None
            best_len = 0
            j = i
            while j < len(data) and data[j] in node:
                node = node[data[j]]
                j += 1
                if -1 in node:
                    best, best_len = node[-1], j - i
            if best is None:
                i += 1  # skip unencodable byte
            else:
                out.append(best)
                i += best_len
        return out

    def decode(self, ids: List[int]) -> str:
        return b"".join(self._id_to_bytes.get(i, b"") for i in ids).decode(
            "utf-8", errors="replace")


class IncrementalDecoder:
    """Amortized-O(1)-per-token detokenizer for streaming paths.

    decode() over a growing token list is O(n), so calling it on every
    emitted token (stop-sequence checks, SSE deltas) is O(n^2) — and it
    runs on the batcher's single scheduler thread, stalling every other
    slot in the batch. This keeps a committed text prefix and re-decodes
    only a bounded uncommitted tail. Commits are verified: the tail is
    only split where decode(head)+decode(rest) == decode(tail), because
    byte-level BPE may split one multi-byte character across tokens and
    a blind prefix commit there would corrupt the text.
    """

    def __init__(self, tokenizer, window: int = 48, commit: int = 16):
        self.tok = tokenizer
        self.window = window
        self.commit = commit
        self._chunks: List[str] = []   # committed text pieces
        self._clen = 0                 # total committed chars
        self._tail: List[int] = []
        self._tail_text = ""

    @property
    def length(self) -> int:
        """Chars decoded so far (committed + tail)."""
        return self._clen + len(self._tail_text)

    @property
    def text(self) -> str:
        return "".join(self._chunks) + self._tail_text

    def text_from(self, offset: int) -> str:
        """Decoded text from char `offset` to the end — walks only the
        needed suffix, so a bounded-window caller stays O(window)."""
        if offset >= self._clen:
            return self._tail_text[max(0, offset - self._clen):]
        parts = [self._tail_text]
        need = self._clen - offset
        for ch in reversed(self._chunks):
            if need <= 0:
                break
            if len(ch) <= need:
                parts.append(ch)
                need -= len(ch)
            else:
                parts.append(ch[-need:])
                need = 0
        return "".join(reversed(parts))

    def push(self, tok_id: int) -> None:
        """Append one token id."""
        self._tail.append(int(tok_id))
        self._tail_text = self.tok.decode(self._tail)
        if len(self._tail) > self.window:
            # try a few split points: a single fixed cut could sit
            # permanently inside one multi-byte character
            for cut in range(self.commit,
                             min(self.commit + 4, len(self._tail))):
                head = self._tail[:cut]
                rest = self._tail[cut:]
                h, r = self.tok.decode(head), self.tok.decode(rest)
                if h + r == self._tail_text:
                    self._chunks.append(h)
                    self._clen += len(h)
                    self._tail = rest
                    self._tail_text = r
                    break


class AnyTokenizer:
    """Dispatcher (reference AnyTokenizer enum)."""

    @staticmethod
    def load(source: str):
        if source == "bytes":
            return ByteTokenizer()
        if os.path.isdir(source):
            p = os.path.join(source, "tokenizer.json")
            if os.path.exists(p):
                tok = HFTokenizer.from_file(p)
                _attach_chat_config(tok, _read_tokenizer_config(source))
                return tok
            raise FileNotFoundError(f"no tokenizer.json in {source}")
        if source.endswith(".json"):
            return HFTokenizer.from_file(source)
        if source.endswith(".txt"):
            return RwkvWorldTokenizer(source)
        if source.lstrip().startswith("{"):
            return HFTokenizer.from_json(source)
        raise ValueError(f"cannot identify tokenizer source {source!r}")
