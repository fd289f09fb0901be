"""DFA-constrained decoding on the port, against the JAX package.

* The port's constrained.py is a copy of the reference's: the byte DFA,
  the TokenDFA tables (trans, accepting, start, done) and the JSON
  schema regexes must be array_equal / equal, under the byte tokenizer,
  a byte-level BPE tokenizer and a sentencepiece-style (metaspace,
  <0xNN> byte tokens) vocabulary.
* The tiny llama of tests/test_torch_port_slice.py (2 layers, hidden
  256, vocab 512, f32 cache; each package's Model from the same ONNX
  bytes) decodes under a constraint: greedy tokens must equal the JAX
  package's exactly, batched too, dense and int8, with a logit bias and
  with penalties. Sampled output cannot match (jax.random and
  torch.Generator differ), so it must fullmatch the pattern, and every
  token must be admitted by the table from the state before it.
* _pick_token on rows that the mask leaves mostly -inf: top-k above the
  number of candidates, top-p and min-p on one candidate, the
  repetition penalty on -inf, give only admitted tokens.
"""

import json
import re

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from whisper_tensor_tpu import constrained as ref_c  # noqa: E402
from whisper_tensor_tpu import tokenizer as ref_tok  # noqa: E402
from whisper_tensor_tpu.interfaces.text import (  # noqa: E402
    SamplingParams as JaxSamplingParams)
from whisper_tensor_tpu_torch import constrained as port_c  # noqa: E402
from whisper_tensor_tpu_torch import tokenizer as port_tok  # noqa: E402
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402
from whisper_tensor_tpu_torch.interfaces.text import (  # noqa: E402
    SamplingParams, _dfa_advance, _dfa_mask, _pick_token)

from tests.test_torch_port_frontend import _hf_dir  # noqa: E402
from tests.test_torch_port_slice import _pair, V  # noqa: E402
from tests.test_torch_port_slice import models  # noqa: F401,E402 (fixture)

PATTERNS = [r"ab{1,4}c", r"[0-9]{2,5}", r"(yes|no|maybe)!?", r"x*y",
            r"\d+\.\d\d", r"[^a-z]{1,3}z", r"(café|na.ve)",
            r"[A-Z][a-z]{0,6}( [A-Z][a-z]{0,6})?"]
SCHEMAS = [
    {"type": "integer"},
    {"type": "boolean"},
    {"enum": ["red", "green", 3, None]},
    {"type": "object", "properties": {"ok": {"type": "boolean"},
                                      "n": {"enum": [1, 2, 3]}},
     "required": ["ok", "n"]},
    {"type": "array", "items": {"type": "integer"}, "minItems": 1,
     "maxItems": 3},
    {"anyOf": [{"const": "a"}, {"type": "number"}]},
    {"type": "object", "properties": {"s": {"type": "string"},
                                      "opt": {"type": "null"}},
     "required": ["s"]},
]
# finite languages: greedy decoding reaches eos inside the budget
FINITE = [r"ab{1,4}c", r"(yes|no|maybe)!", r"[0-9]{2,3}",
          {"type": "object", "properties": {"ok": {"type": "boolean"},
                                            "n": {"enum": [1, 2, 3]}},
           "required": ["ok", "n"]}]


def _metaspace_dir(tmp_path):
    """A sentencepiece-style vocabulary (no byte-level alphabet):
    metaspace pieces, <0xNN> byte tokens and control tokens."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for piece in ["▁a", "▁b", "b", "c", "ab", "▁yes", "no",
                  "1", "23", "▁", "café", "!"]:
        vocab.setdefault(piece, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.save(str(tmp_path / "tokenizer.json"))
    return str(tmp_path)


@pytest.fixture(scope="module", params=["bytes", "bpe", "metaspace"])
def tokenizers(request, tmp_path_factory):
    src = {"bytes": lambda d: "bytes", "bpe": _hf_dir,
           "metaspace": _metaspace_dir}[request.param](
        tmp_path_factory.mktemp(request.param))
    return (ref_tok.AnyTokenizer.load(src), port_tok.AnyTokenizer.load(src))


def test_token_byte_strings_are_the_references(tokenizers):
    ref, port = tokenizers
    assert port_c.token_byte_strings(port) == ref_c.token_byte_strings(ref)


@pytest.mark.parametrize("pattern", PATTERNS + SCHEMAS,
                         ids=lambda c: json.dumps(c)[:40])
def test_token_dfa_tables_are_the_references(tokenizers, pattern):
    """The tables over each vocabulary, padded 5 ids past it (the
    model's logit width may exceed the tokenizer's); a schema's regex
    first."""
    ref, port = tokenizers
    if isinstance(pattern, dict):
        schema = pattern
        pattern = port_c.json_schema_to_regex(schema)
        assert pattern == ref_c.json_schema_to_regex(schema)
    width = len(port_c.token_byte_strings(port)) + 5
    eos = 2
    want = ref_c.compile_token_dfa(pattern, ref, eos, vocab_size=width)
    got = port_c.compile_token_dfa(pattern, port, eos, vocab_size=width)
    np.testing.assert_array_equal(got.trans, want.trans)
    np.testing.assert_array_equal(got.accepting, want.accepting)
    assert (got.start, got.done, got.eos_token_id, got.pattern) == (
        want.start, want.done, want.eos_token_id, want.pattern)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_byte_dfa_is_the_references(pattern):
    got, want = (port_c.compile_regex_to_dfa(pattern),
                 ref_c.compile_regex_to_dfa(pattern))
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.accepting, want.accepting)


@pytest.mark.parametrize("bad", [r"a(b", r"[z-a]", r"*a", r"a{3,1}"])
def test_regex_errors_match(bad):
    with pytest.raises(ValueError) as want:
        ref_c.compile_regex_to_dfa(bad)
    with pytest.raises(port_c.RegexError) as got:
        port_c.compile_regex_to_dfa(bad)
    assert str(got.value) == str(want.value)


# -- decoding ------------------------------------------------------------

def _constraint(iface, c):
    return (iface.compile_constraint(json_schema=c) if isinstance(c, dict)
            else iface.compile_constraint(regex=c))


def _pattern(c):
    return port_c.json_schema_to_regex(c) if isinstance(c, dict) else c


def _prompt(B, L=6, seed=3):
    return np.random.default_rng(seed).integers(3, 259, (B, L)).astype(
        np.int64)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("c", FINITE + [r"[0-9]{2,5}", r"x*y"],
                         ids=lambda c: _pattern(c)[:24])
def test_constrained_greedy_is_token_exact(models, quantize, c):  # noqa: F811
    """Greedy under the constraint, two rows, f32: the JAX package's
    tokens exactly; the text up to eos fullmatches a finite pattern."""
    ref, port = _pair(models, DType.F32, quantize)
    tok = port_tok.ByteTokenizer()
    ref.tokenizer, port.tokenizer = ref_tok.ByteTokenizer(), tok
    want = ref.generate_tokens(_prompt(2), 24, constraint=_constraint(ref, c))
    cons = _constraint(port, c)
    got = port.generate_tokens(_prompt(2), 24, constraint=cons)
    np.testing.assert_array_equal(got, want)
    if c in FINITE:
        for row in got:
            cut = list(row).index(cons.eos_token_id)
            assert re.fullmatch(_pattern(c), tok.decode(list(row[:cut])))


def test_constrained_greedy_with_bias_and_penalties(models):  # noqa: F811
    """The bias before the mask and the penalties inside the pick, in
    the reference's order: the JAX package's tokens exactly."""
    ref, port = _pair(models, DType.F32, None)
    ref.tokenizer, port.tokenizer = (ref_tok.ByteTokenizer(),
                                     port_tok.ByteTokenizer())
    bias = np.zeros(V, np.float32)
    bias[[ord("b") + 3, ord("7") + 3]] = 4.0
    for sp in (None, SamplingParams(temperature=0.0, repetition_penalty=1.3,
                                    presence_penalty=0.5,
                                    frequency_penalty=0.25)):
        want = ref.generate_tokens(
            _prompt(2, seed=4), 16,
            sampling=None if sp is None else JaxSamplingParams(**vars(sp)),
            constraint=ref.compile_constraint(regex=r"(ab{1,6}c|[0-9]{3})"),
            logit_bias=bias)
        got = port.generate_tokens(
            _prompt(2, seed=4), 16, sampling=sp,
            constraint=port.compile_constraint(regex=r"(ab{1,6}c|[0-9]{3})"),
            logit_bias=bias)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [r"ab{1,4}c", FINITE[3]],
                         ids=["regex", "schema"])
def test_run_string_in_string_out_is_the_references(models, c):  # noqa: F811
    ref, port = _pair(models, DType.F32, None)
    ref.tokenizer, port.tokenizer = (ref_tok.ByteTokenizer(),
                                     port_tok.ByteTokenizer())
    kw = {"json_schema": c} if isinstance(c, dict) else {"regex": c}
    got = port.run_string_in_string_out("hello", 32, **kw)
    assert got == ref.run_string_in_string_out("hello", 32, **kw)
    assert re.fullmatch(_pattern(c), got)
    # the byte tokenizer's eos was taken for the constraint, as the
    # reference takes it
    assert port.eos_token_id == ref.eos_token_id == port_tok.ByteTokenizer.EOS


def _admitted(cons, toks):
    """Every token admitted by the table from the state before it: eos
    only in an accepting state, and then only eos."""
    state = cons.start
    for t in toks:
        t = int(t)
        if t == cons.eos_token_id:
            assert cons.accepting[state]
            state = cons.done
        else:
            assert state != cons.done and cons.trans[state, t] >= 0
            state = int(cons.trans[state, t])


SAMPLED = [SamplingParams(temperature=1.0, seed=1),
           SamplingParams(temperature=1.5, top_k=40, seed=2),
           SamplingParams(temperature=0.7, top_p=0.5, seed=3),
           SamplingParams(temperature=1.0, min_p=0.3, seed=4),
           SamplingParams(temperature=1.0, top_k=3, top_p=0.9, min_p=0.05,
                          repetition_penalty=1.5, presence_penalty=0.3,
                          frequency_penalty=0.2, seed=5)]


@pytest.mark.parametrize("sp", SAMPLED, ids=lambda sp: f"seed{sp.seed}")
@pytest.mark.parametrize("c", FINITE, ids=lambda c: _pattern(c)[:24])
def test_constrained_sampling_stays_in_the_language(models, sp, c):  # noqa: F811
    """Sampled rows (4 of them) give only admitted tokens and end in a
    full match: top-k above the candidate count, top-p and min-p on a
    single candidate, penalties on -inf logits."""
    _, port = _pair(models, DType.F32, None)
    port.tokenizer = tok = port_tok.ByteTokenizer()
    cons = _constraint(port, c)
    toks = port.generate_tokens(_prompt(4, seed=sp.seed), 40, sampling=sp,
                                constraint=cons)
    for row in toks:
        _admitted(cons, row)
        cut = list(row).index(cons.eos_token_id)
        assert re.fullmatch(_pattern(c), tok.decode(list(row[:cut])))


def test_mask_and_advance_are_the_references():
    """_dfa_mask / _dfa_advance on a table row against the JAX package's
    helpers: the same masked logits and next states."""
    import jax.numpy as jnp

    from whisper_tensor_tpu.interfaces.text import (
        _dfa_advance as jax_advance, _dfa_mask as jax_mask)

    rng = np.random.default_rng(0)
    row = rng.integers(-1, 5, (3, 40)).astype(np.int32)
    acc = np.array([True, False, True])
    logits = rng.standard_normal((3, 40)).astype(np.float32)
    got = _dfa_mask(torch.from_numpy(logits), torch.from_numpy(row),
                    torch.from_numpy(acc), 7)
    want = jax_mask(jnp.asarray(logits), jnp.asarray(row), jnp.asarray(acc),
                    7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tok = np.array([7, 3, 11])
    np.testing.assert_array_equal(
        _dfa_advance(torch.from_numpy(row), torch.from_numpy(tok), 7,
                     9).numpy(),
        np.asarray(jax_advance(jnp.asarray(row), jnp.asarray(tok), 7, 9)))


@pytest.mark.parametrize("sp", SAMPLED, ids=lambda sp: f"seed{sp.seed}")
def test_pick_token_on_masked_rows_picks_admitted_tokens(sp):
    """Rows with one, two and five finite logits among 64, and the
    token counts the penalties read: 200 draws pick only finite ones."""
    lg = torch.full((3, 64), -torch.inf)
    admitted = [[5], [1, 60], [0, 9, 17, 33, 63]]
    for r, ids in enumerate(admitted):
        lg[r, ids] = torch.linspace(-2.0, 3.0, len(ids))
    seen = torch.zeros((3, 64), dtype=torch.int32)
    seen[:, [5, 9, 60, 10]] = 2
    gen = torch.Generator().manual_seed(sp.seed)
    for _ in range(200):
        tok = _pick_token(lg, gen, sp, seen)
        for r, ids in enumerate(admitted):
            assert int(tok[r]) in ids
