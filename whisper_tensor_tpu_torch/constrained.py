"""Constrained (structured) decoding: regex / JSON-schema guided generation.

The port's copy of whisper_tensor_tpu/constrained.py (numpy only, no
change to the algorithm): a regex is compiled to a byte-level DFA, the
DFA is lifted to a token-level transition table over the tokenizer's
vocabulary, and the decode loop masks logits each step so sampling can
only pick tokens that keep the output inside the language. The
transition table is plain device data -- (S + 1, V) int32, one row
gathered per step by each row's state -- so the decode loop never reads
the state back to the host (interfaces/text.py).

Pipeline:
  regex  --parse-->  AST  --Thompson-->  byte NFA  --subset+minimize-->
  byte DFA  --vocab walk-->  TokenDFA(trans (S, V), accepting (S,))

Non-ASCII: the engine works on UTF-8 bytes. `.`  and negated classes
(e.g. [^"]) also admit any well-formed multi-byte UTF-8 sequence via
the standard UTF-8 range automaton; literal non-ASCII characters match
their exact UTF-8 byte sequence. Character ranges must stay within
ASCII (a-z style); non-ASCII ranges are rejected with a clear error.

Left out: the RWKV World vocabulary in token_byte_strings (the port's
tokenizer does not load it either); such a tokenizer raises.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# regex parsing
# ---------------------------------------------------------------------------

_ASCII = frozenset(range(0x80))
_DIGITS = frozenset(range(ord("0"), ord("9") + 1))
_WORD = frozenset(
    list(range(ord("a"), ord("z") + 1)) + list(range(ord("A"), ord("Z") + 1))
    + list(range(ord("0"), ord("9") + 1)) + [ord("_")])
_SPACE = frozenset(b" \t\n\r\f\v")

# AST node kinds (plain tuples):
#   ("set", frozenset[int], non_ascii: bool)  one char: byte-set | any
#                                             multi-byte UTF-8 char
#   ("lit", bytes)                            exact byte sequence
#   ("cat", [nodes]) ("alt", [nodes]) ("rep", node, min, max|None)


class RegexError(ValueError):
    pass


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str) -> RegexError:
        return RegexError(f"{msg} at position {self.i} in {self.p!r}")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self):
        node = self.alt()
        if self.i != len(self.p):
            raise self.error(f"unexpected {self.p[self.i]!r}")
        return node

    def alt(self):
        branches = [self.cat()]
        while self.peek() == "|":
            self.next()
            branches.append(self.cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def cat(self):
        parts = []
        while self.peek() not in (None, "|", ")"):
            parts.append(self.repeat())
        if not parts:
            return ("lit", b"")
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def repeat(self):
        node = self.atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.next()
                node = ("rep", node, 0, None)
            elif ch == "+":
                self.next()
                node = ("rep", node, 1, None)
            elif ch == "?":
                self.next()
                node = ("rep", node, 0, 1)
            elif ch == "{":
                save = self.i
                self.next()
                digits = ""
                while self.peek() and self.peek().isdigit():
                    digits += self.next()
                if not digits:          # literal '{'
                    self.i = save
                    break
                lo = int(digits)
                hi = lo
                if self.peek() == ",":
                    self.next()
                    digits = ""
                    while self.peek() and self.peek().isdigit():
                        digits += self.next()
                    hi = int(digits) if digits else None
                if self.peek() != "}":
                    self.i = save
                    break
                self.next()
                if hi is not None and hi < lo:
                    raise self.error(f"bad repeat bounds {{{lo},{hi}}}")
                node = ("rep", node, lo, hi)
            else:
                break
            # a '?' right after a quantifier is the lazy marker: laziness
            # changes match preference, never the recognized language —
            # consume it (parsing it as a (x{m,n})? nesting WOULD change
            # the language). Possessive '+' does change the language in
            # full-match position: reject.
            if self.peek() == "?":
                self.next()
            elif self.peek() == "+":
                raise self.error("possessive quantifiers are unsupported")
        return node

    def atom(self):
        ch = self.peek()
        if ch is None:
            raise self.error("unexpected end of pattern")
        if ch == "(":
            self.next()
            if self.peek() == "?":
                self.next()
                if self.peek() == ":":
                    self.next()
                else:
                    raise self.error("only (?:...) groups are supported")
            node = self.alt()
            if self.peek() != ")":
                raise self.error("unbalanced parenthesis")
            self.next()
            return node
        if ch == "[":
            return self.char_class()
        if ch == ".":
            self.next()
            return ("set", frozenset(_ASCII - {0x0A}), True)
        if ch in ")|":
            raise self.error(f"unexpected {ch!r}")
        if ch in "*+?":
            raise self.error(f"nothing to repeat with {ch!r}")
        if ch in "^$":
            raise self.error(
                "anchors are not supported (patterns always full-match)")
        if ch == "\\":
            self.next()
            return self.escape(in_class=False)
        self.next()
        data = ch.encode("utf-8")
        if len(data) == 1:
            return ("set", frozenset(data), False)
        return ("lit", data)

    def escape(self, in_class: bool):
        """After a backslash: return ('set', bytes, non_ascii) node."""
        ch = self.peek()
        if ch is None:
            raise self.error("trailing backslash")
        self.next()
        simple = {"n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C, "v": 0x0B,
                  "0": 0x00, "a": 0x07, "e": 0x1B}
        if ch in simple:
            return ("set", frozenset({simple[ch]}), False)
        if ch == "x":
            hexs = self.p[self.i:self.i + 2]
            if len(hexs) != 2:
                raise self.error("bad \\x escape")
            self.i += 2
            val = int(hexs, 16)
            if val < 0x80:
                return ("set", frozenset({val}), False)
            return ("lit", chr(val).encode("utf-8"))
        if ch == "u":
            hexs = self.p[self.i:self.i + 4]
            if len(hexs) != 4:
                raise self.error("bad \\u escape")
            self.i += 4
            cp = int(hexs, 16)
            if cp < 0x80:
                return ("set", frozenset({cp}), False)
            return ("lit", chr(cp).encode("utf-8"))
        if ch == "d":
            return ("set", _DIGITS, False)
        if ch == "D":
            return ("set", frozenset(_ASCII - _DIGITS), True)
        if ch == "w":
            return ("set", _WORD, False)
        if ch == "W":
            return ("set", frozenset(_ASCII - _WORD), True)
        if ch == "s":
            return ("set", _SPACE, False)
        if ch == "S":
            return ("set", frozenset(_ASCII - _SPACE), True)
        # punctuation / metachar escape
        data = ch.encode("utf-8")
        if len(data) == 1:
            return ("set", frozenset(data), False)
        return ("lit", data)

    def char_class(self):
        assert self.next() == "["
        negate = False
        if self.peek() == "^":
            negate = True
            self.next()
        members: set = set()
        non_ascii_lits: List[bytes] = []
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise self.error("unterminated character class")
            if ch == "]" and not first:
                self.next()
                break
            first = False
            if ch == "\\":
                self.next()
                node = self.escape(in_class=True)
                if node[0] == "lit":
                    non_ascii_lits.append(node[1])
                    continue
                members |= node[1]
                # a single escaped byte (\x00, \n, \-) can start a range
                lo = next(iter(node[1])) if len(node[1]) == 1 else None
            else:
                self.next()
                data = ch.encode("utf-8")
                if len(data) > 1:
                    non_ascii_lits.append(data)
                    lo = None
                else:
                    lo = data[0]
            # range?
            if lo is not None and self.peek() == "-" and \
                    self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                self.next()
                hi_ch = self.next()
                if hi_ch == "\\":
                    hnode = self.escape(in_class=True)
                    if hnode[0] == "lit" or len(hnode[1]) != 1:
                        raise self.error("bad range endpoint")
                    hi = next(iter(hnode[1]))
                else:
                    hdata = hi_ch.encode("utf-8")
                    if len(hdata) > 1:
                        raise self.error(
                            "non-ASCII range endpoints are not supported")
                    hi = hdata[0]
                if hi < lo:
                    raise self.error("reversed range")
                members |= set(range(lo, hi + 1))
            elif lo is not None:
                members.add(lo)
        if negate:
            if non_ascii_lits:
                raise self.error(
                    "negated classes with non-ASCII members are unsupported")
            return ("set", frozenset(_ASCII - members), True)
        base = ("set", frozenset(members), False)
        if not non_ascii_lits:
            return base
        branches = [base] if members else []
        branches += [("lit", b) for b in non_ascii_lits]
        return branches[0] if len(branches) == 1 else ("alt", branches)


# ---------------------------------------------------------------------------
# Thompson NFA over bytes
# ---------------------------------------------------------------------------

class _NFA:
    def __init__(self):
        self.n = 0
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[FrozenSet[int], int]]] = []

    def state(self) -> int:
        self.n += 1
        self.eps.append([])
        self.edges.append([])
        return self.n - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].append(b)

    def add_edge(self, a: int, byteset: FrozenSet[int], b: int) -> None:
        if byteset:
            self.edges[a].append((byteset, b))


# UTF-8 continuation/lead byte classes for the "any non-ASCII char"
# automaton (well-formed sequences only, surrogates excluded)
_CONT = frozenset(range(0x80, 0xC0))
_UTF8_TAILS: Sequence[Tuple[FrozenSet[int], Sequence[FrozenSet[int]]]] = (
    (frozenset(range(0xC2, 0xE0)), (_CONT,)),
    (frozenset({0xE0}), (frozenset(range(0xA0, 0xC0)), _CONT)),
    (frozenset(range(0xE1, 0xED)), (_CONT, _CONT)),
    (frozenset({0xED}), (frozenset(range(0x80, 0xA0)), _CONT)),
    (frozenset(range(0xEE, 0xF0)), (_CONT, _CONT)),
    (frozenset({0xF0}), (frozenset(range(0x90, 0xC0)), _CONT, _CONT)),
    (frozenset(range(0xF1, 0xF4)), (_CONT, _CONT, _CONT)),
    (frozenset({0xF4}), (frozenset(range(0x80, 0x90)), _CONT, _CONT)),
)


def _emit_any_nonascii(nfa: _NFA, start: int, end: int) -> None:
    """start --(any well-formed multi-byte UTF-8 sequence)--> end."""
    for lead, tails in _UTF8_TAILS:
        cur = start
        seq: List[FrozenSet[int]] = [lead, *tails]
        for k, byteset in enumerate(seq):
            nxt = end if k + 1 == len(seq) else nfa.state()
            nfa.add_edge(cur, byteset, nxt)
            cur = nxt


def _build_nfa(node, nfa: _NFA, start: int, end: int) -> None:
    kind = node[0]
    if kind == "set":
        _, byteset, non_ascii = node
        nfa.add_edge(start, byteset, end)
        if non_ascii:
            _emit_any_nonascii(nfa, start, end)
    elif kind == "lit":
        data = node[1]
        if not data:
            nfa.add_eps(start, end)
            return
        cur = start
        for k, byte in enumerate(data):
            nxt = end if k + 1 == len(data) else nfa.state()
            nfa.add_edge(cur, frozenset({byte}), nxt)
            cur = nxt
    elif kind == "cat":
        cur = start
        parts = node[1]
        for k, part in enumerate(parts):
            nxt = end if k + 1 == len(parts) else nfa.state()
            _build_nfa(part, nfa, cur, nxt)
            cur = nxt
    elif kind == "alt":
        for branch in node[1]:
            s, e = nfa.state(), nfa.state()
            nfa.add_eps(start, s)
            nfa.add_eps(e, end)
            _build_nfa(branch, nfa, s, e)
    elif kind == "rep":
        _, inner, lo, hi = node
        cur = start
        for _ in range(lo):
            nxt = nfa.state()
            _build_nfa(inner, nfa, cur, nxt)
            cur = nxt
        if hi is None:            # Kleene tail
            loop = nfa.state()
            nfa.add_eps(cur, loop)
            s, e = nfa.state(), nfa.state()
            nfa.add_eps(loop, s)
            _build_nfa(inner, nfa, s, e)
            nfa.add_eps(e, loop)
            nfa.add_eps(loop, end)
        else:
            for _ in range(hi - lo):
                nxt = nfa.state()
                _build_nfa(inner, nfa, cur, nxt)
                nfa.add_eps(cur, end)
                cur = nxt
            nfa.add_eps(cur, end)
    else:                         # pragma: no cover
        raise RegexError(f"unknown AST node {kind}")


# ---------------------------------------------------------------------------
# subset construction + Moore minimization -> byte DFA
# ---------------------------------------------------------------------------

@dataclass
class ByteDFA:
    """table[s, b] = next state or -1; state 0 is the start."""

    table: np.ndarray          # (S, 256) int32
    accepting: np.ndarray      # (S,) bool

    def matches(self, data: bytes) -> bool:
        s = 0
        for byte in data:
            s = int(self.table[s, byte])
            if s < 0:
                return False
        return bool(self.accepting[s])


def compile_regex_to_dfa(pattern: str, max_states: int = 4096) -> ByteDFA:
    ast = _Parser(pattern).parse()
    nfa = _NFA()
    start, end = nfa.state(), nfa.state()
    _build_nfa(ast, nfa, start, end)

    # eps-closures (iterative DFS per state set)
    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    # per-NFA-state byte->targets, densified once for speed
    per_state: List[Dict[int, List[int]]] = []
    for s in range(nfa.n):
        d: Dict[int, List[int]] = {}
        for byteset, t in nfa.edges[s]:
            for b in byteset:
                d.setdefault(b, []).append(t)
        per_state.append(d)

    start_set = closure(frozenset({start}))
    index: Dict[FrozenSet[int], int] = {start_set: 0}
    order = [start_set]
    rows: List[np.ndarray] = []
    k = 0
    while k < len(order):
        cur = order[k]
        k += 1
        row = np.full(256, -1, np.int32)
        # group target sets by byte
        byte_targets: Dict[int, set] = {}
        for s in cur:
            for b, ts in per_state[s].items():
                byte_targets.setdefault(b, set()).update(ts)
        for b, ts in byte_targets.items():
            nxt = closure(frozenset(ts))
            j = index.get(nxt)
            if j is None:
                j = len(order)
                if j >= max_states:
                    raise RegexError(
                        f"regex DFA exceeds {max_states} states; simplify "
                        f"the pattern or raise max_states")
                index[nxt] = j
                order.append(nxt)
            row[b] = j
        rows.append(row)
    table = np.stack(rows)                                # (S, 256)
    accepting = np.array([end in s for s in order], bool)

    return _minimize(ByteDFA(table, accepting))


def _minimize(dfa: ByteDFA) -> ByteDFA:
    """Moore partition refinement (dead states stay folded into -1)."""
    S = dfa.table.shape[0]
    part = dfa.accepting.astype(np.int64).copy()      # initial: accept split
    while True:
        # signature: (current class, classes of 256 successors)
        succ = np.where(dfa.table >= 0, part[np.clip(dfa.table, 0, None)], -1)
        sig = np.concatenate([part[:, None], succ], axis=1)
        _, new_part = np.unique(sig, axis=0, return_inverse=True)
        if (new_part == part).all():
            break
        part = new_part
    n_classes = int(part.max()) + 1
    if n_classes == S:
        return dfa
    # one representative state per class, numbered in first-seen order so
    # the start state's class becomes the new state 0
    idx_of_class: Dict[int, int] = {}
    reps: List[int] = []
    for s in range(S):
        c = int(part[s])
        if c not in idx_of_class:
            idx_of_class[c] = len(reps)
            reps.append(s)
    table = np.full((len(reps), 256), -1, np.int32)
    accepting = np.zeros(len(reps), bool)
    for i, s in enumerate(reps):
        row = dfa.table[s]
        ok = row >= 0
        table[i, ok] = [idx_of_class[int(part[t])] for t in row[ok]]
        accepting[i] = dfa.accepting[s]
    return ByteDFA(table, accepting)


# ---------------------------------------------------------------------------
# tokenizer vocab -> token-level transition table
# ---------------------------------------------------------------------------

def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte-level BPE byte<->printable-unicode table (the public
    openai/gpt-2 encoder mapping, reimplemented from its definition)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def token_byte_strings(tokenizer) -> List[Optional[bytes]]:
    """Per-token byte string for any of our tokenizers; None = token is
    special/control (never allowed under a constraint)."""
    # ByteTokenizer: ids 3..258 are bytes, 0..2 specials
    if type(tokenizer).__name__ == "ByteTokenizer":
        out: List[Optional[bytes]] = [None] * 259
        for b in range(256):
            out[b + 3] = bytes([b])
        return out
    # RWKV world vocab: explicit byte strings
    if hasattr(tokenizer, "_id_to_bytes"):
        raise NotImplementedError(
            "constrained decoding over the RWKV World vocabulary is not "
            "ported to PyTorch yet")
    # HF tokenizers
    tok = getattr(tokenizer, "_tok", None)
    if tok is None:
        raise TypeError(
            f"cannot derive token byte strings from {type(tokenizer)}")
    vocab: Dict[str, int] = tok.get_vocab()
    size = tok.get_vocab_size()
    out = [None] * size
    u2b = {u: b for b, u in _bytes_to_unicode().items()}
    strings = list(vocab.items())
    n_bytelevel = sum(1 for s, _ in strings
                      if s and all(c in u2b for c in s))
    byte_level = n_bytelevel >= 0.8 * max(1, len(strings))
    special = set()
    try:      # added/special tokens must never be sampled by a constraint
        for t in tok.get_added_tokens_decoder().values():
            special.add(str(t.content) if hasattr(t, "content") else str(t))
    except Exception:
        pass
    for s, i in strings:
        if i >= size or s in special:
            continue
        if byte_level:
            if s and all(c in u2b for c in s):
                out[i] = bytes(u2b[c] for c in s)
            continue              # non-mappable in a byte-level vocab: skip
        if len(s) == 6 and s.startswith("<0x") and s.endswith(">"):
            try:
                out[i] = bytes([int(s[3:5], 16)])
                continue
            except ValueError:
                pass
        if s.startswith("<") and s.endswith(">") and len(s) > 2:
            continue              # looks like a control token
        out[i] = s.replace("▁", " ").encode("utf-8")
    return out


@dataclass
class TokenDFA:
    """Token-level DFA for in-scan constrained decoding.

    trans[s, v] = next state, or -1 when token v is not allowed in
    state s. State `done` (the last row) admits nothing; eos is allowed
    exactly in accepting states (and in `done`, so finished rows keep
    emitting eos). All arrays are plain numpy — the interface ships
    them to the device once per (pattern, tokenizer) pair.
    """

    trans: np.ndarray          # (S, V) int32
    accepting: np.ndarray      # (S,) bool
    start: int
    done: int
    eos_token_id: int
    pattern: str = ""

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]


def compile_token_dfa(pattern: str, tokenizer, eos_token_id: int,
                      vocab_size: Optional[int] = None) -> TokenDFA:
    """Compile `pattern` against `tokenizer` into a TokenDFA whose table
    is padded to the model's vocab size (logit width)."""
    dfa = compile_regex_to_dfa(pattern)
    tbytes = token_byte_strings(tokenizer)
    V = vocab_size if vocab_size is not None else len(tbytes)
    S = dfa.table.shape[0]

    ids = [i for i, bs in enumerate(tbytes) if bs and i < V]
    if not ids:
        raise RegexError("no usable tokens in the vocabulary")
    lmax = max(len(tbytes[i]) for i in ids)
    padded = np.zeros((len(ids), lmax), np.int32)
    lens = np.zeros(len(ids), np.int32)
    for k, i in enumerate(ids):
        bs = tbytes[i]
        padded[k, :len(bs)] = np.frombuffer(bs, np.uint8)
        lens[k] = len(bs)

    # vectorized walk: states (S, T) over byte positions; dead = -1
    cur = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None],
                          (S, len(ids))).copy()
    for pos in range(lmax):
        active = (pos < lens)[None, :] & (cur >= 0)
        nxt = np.where(active,
                       dfa.table[np.clip(cur, 0, None), padded[None, :, pos]],
                       cur)
        cur = nxt.astype(np.int32)

    trans = np.full((S + 1, V), -1, np.int32)      # +1 = done sink
    trans[:S, ids] = cur
    trans[:, eos_token_id] = -1                    # eos handled separately
    accepting = np.concatenate([dfa.accepting, [True]])  # done accepts eos
    return TokenDFA(trans=trans, accepting=accepting, start=0, done=S,
                    eos_token_id=eos_token_id, pattern=pattern)


# ---------------------------------------------------------------------------
# JSON schema -> regex (canonical form: no inter-token whitespace)
# ---------------------------------------------------------------------------

_JSON_STRING = (r'"([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*"')
_JSON_NUMBER = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?"
_JSON_INTEGER = r"-?(0|[1-9][0-9]*)"


def _regex_escape(text: str) -> str:
    out = []
    for ch in text:
        if ch in r"\.^$*+?{}[]()|/":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def json_schema_to_regex(schema) -> str:
    """Supported subset: type string/number/integer/boolean/null, enum,
    const, object (properties, emitted in declaration order; properties
    listed in `required` are mandatory, the rest optional), array
    (items, minItems/maxItems), anyOf/oneOf. Canonical output: no
    whitespace between tokens (the model can still put whitespace
    inside strings). Reference: net-new (the upstream framework has no
    structured-output support)."""
    if isinstance(schema, str):
        schema = json.loads(schema)
    return _schema_regex(schema)


def _schema_regex(sc) -> str:
    if sc is True or sc == {}:
        # any JSON value (one level of nesting only, to keep DFAs small)
        scalar = (f"({_JSON_STRING}|{_JSON_NUMBER}|true|false|null)")
        return scalar
    if "const" in sc:
        return _regex_escape(json.dumps(sc["const"], separators=(",", ":")))
    if "enum" in sc:
        opts = [_regex_escape(json.dumps(v, separators=(",", ":")))
                for v in sc["enum"]]
        return "(" + "|".join(opts) + ")"
    if "anyOf" in sc or "oneOf" in sc:
        subs = sc.get("anyOf") or sc.get("oneOf")
        return "(" + "|".join(_schema_regex(s) for s in subs) + ")"
    t = sc.get("type")
    if isinstance(t, list):
        return "(" + "|".join(_schema_regex({**sc, "type": one})
                              for one in t) + ")"
    if t == "string":
        return _JSON_STRING
    if t == "number":
        return _JSON_NUMBER
    if t == "integer":
        return _JSON_INTEGER
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = _schema_regex(sc.get("items", {"type": "number"}))
        lo = int(sc.get("minItems", 0))
        hi = sc.get("maxItems")
        if hi is None:
            if lo == 0:
                body = f"({item}(,{item})*)?"
            else:
                body = f"{item}(,{item})*" if lo == 1 else (
                    f"{item}" + f"(,{item})" + "{" + str(lo - 1) + ",}")
        else:
            hi = int(hi)
            if lo == 0:
                body = (f"({item}(,{item})" + "{0," + str(max(hi - 1, 0))
                        + "})?") if hi > 0 else ""
            else:
                body = (f"{item}(,{item})" + "{" + str(lo - 1) + ","
                        + str(hi - 1) + "}")
        return r"\[" + body + r"\]"
    if t == "object" or "properties" in sc:
        props = sc.get("properties", {})
        required = set(sc.get("required", list(props)))
        if not props:
            return r"\{\}"
        parts = [(f'"{_regex_escape(name)}":{_schema_regex(sub)}',
                  name in required) for name, sub in props.items()]
        # members appear in declaration order; comma placement is handled
        # by enumerating which member comes FIRST (it takes no leading
        # comma, every later present member takes one). A member can be
        # "first" only if everything before it is optional (absent), and
        # nothing after the first required member can be "first".
        alts = []
        for first, (pair, req) in enumerate(parts):
            if any(r for _, r in parts[:first]):
                break               # a required member was skipped
            tail = "".join(f",{p}" if r else f"(,{p})?"
                           for p, r in parts[first + 1:])
            alts.append(pair + tail)
        body = "(" + "|".join(alts) + ")"
        if not any(r for _, r in parts):        # fully-optional object
            body += "?"
        return r"\{" + body + r"\}"
    raise RegexError(f"unsupported JSON schema fragment: {sc!r}")
