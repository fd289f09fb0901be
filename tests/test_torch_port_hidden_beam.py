"""Hidden states, embeddings, sequence scores and beam search on the
port, against the JAX package.

The tiny llama of tests/test_torch_port_slice.py (2 layers, hidden 256,
2 query heads and 1 KV head of 128, vocab 512; each package's Model
from the same ONNX bytes) at an f32 cache:

* hidden_states, embed (last and mean pooling) and sequence_scores
  stand the JAX package's to 1e-5 of the values' scale (both sum in
  f32, in other orders); beam_search_tokens, with and without a length
  penalty and with an eos id, gives the JAX package's tokens exactly;
* hidden_states runs a prefill pruned at the tap: the lm_head and the
  logits are not in it;
* ROADMAP C12: with quantize="int8" or "q4_0" the lm_head (512 x 256 =
  131,072 elements, above the 65,536 below which weights stay dense)
  becomes a QuantMatMul or PackedMatMul. The JAX package's tap walk
  accepts only MatMul, Einsum and Gemm and raises there; the port finds
  the tap, which equals that tensor in the port's own MilliGraph.eval
  of the graph it runs (1e-5 of scale), and the tap times the
  dequantized lm_head stands the JAX package's quantized logits (1e-4
  of their scale: f32 sums in other orders over K = 256).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from whisper_tensor_tpu_torch.backends.cuda.packed_matmul import (  # noqa: E402
    dequant_repacked)
from whisper_tensor_tpu_torch.dtype import DType  # noqa: E402

from tests.test_torch_port_slice import PROMPT, _pair  # noqa: E402
from tests.test_torch_port_slice import models  # noqa: F401,E402 (fixture)


def _close(got, want, frac=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=frac * np.abs(want).max())


def test_hidden_states_embed_and_scores(models):  # noqa: F811
    ref, port = _pair(models, DType.F32, None)
    _close(port.hidden_states(PROMPT), ref.hidden_states(PROMPT))
    ids = [PROMPT[0], PROMPT[1, :4], PROMPT[0, :1]]
    for pooling in ("last", "mean"):
        got = port.embed(ids, pooling=pooling)
        want = ref.embed(ids, pooling=pooling)
        for g, w in zip(got, want):
            _close(g, w)
            assert abs(np.linalg.norm(g) - 1.0) < 1e-6
    full = np.concatenate([PROMPT, PROMPT[::-1, :5]], axis=1)
    starts, lens = np.array([7, 3]), np.array([12, 10])
    _close(port.sequence_scores(full, starts, lens),
           ref.sequence_scores(full, starts, lens))
    with pytest.raises(ValueError, match="pooling"):
        port.embed(ids, pooling="max")
    with pytest.raises(ValueError, match="non-empty"):
        port.embed([np.zeros(0, np.int64)])


def test_hidden_states_prefill_stops_at_the_tap(models):  # noqa: F811
    _, port = _pair(models, DType.F32, None)
    port.hidden_states(PROMPT)
    run, pruned = port._exec.graph, port._hidden_exec.graph
    assert list(pruned.outputs) == ["hidden"]
    lm_head = next(n for n in run.nodes
                   if run.outputs["logits"] in n.outputs)
    assert lm_head not in pruned.nodes
    assert len(pruned.nodes) < len(run.nodes)
    assert all(n in run.nodes for n in pruned.nodes)


@pytest.mark.parametrize("beam,length_penalty,eos", [
    (2, 0.0, None), (4, 0.0, None), (3, 1.0, None), (3, 0.6, 50),
    (4, 1.0, 99)])
def test_beam_search_is_token_exact(models, beam, length_penalty, eos):  # noqa: F811
    ref, port = _pair(models, DType.F32, None)
    kw = dict(beam=beam, length_penalty=length_penalty, eos_token_id=eos)
    got = port.beam_search_tokens(PROMPT, 7, **kw)
    assert got.shape == (2, 7) and got.dtype == np.int64
    np.testing.assert_array_equal(got, ref.beam_search_tokens(PROMPT, 7, **kw))


def test_beam_search_with_the_models_eos(models):  # noqa: F811
    """eos from the interface (a token the beams reach): finished beams
    extend with eos only."""
    ref, port = _pair(models, DType.F32, None)
    first = ref.beam_search_tokens(PROMPT[:1], 4, beam=3)[0]
    ref.eos_token_id = port.eos_token_id = int(first[2])
    got = port.beam_search_tokens(PROMPT[:1], 6, beam=3, length_penalty=1.0)
    np.testing.assert_array_equal(
        got, ref.beam_search_tokens(PROMPT[:1], 6, beam=3,
                                    length_penalty=1.0))


def _host_feeds(port, ids):
    """The host arrays the port's step graph reads for a prefill of
    `ids` at its bucket, fresh caches."""
    feeds = {"input_ids": np.asarray(port._prompt(ids)[0]),
             "pos": np.zeros((), np.int64)}
    for n, c in zip(port.cache_in_names, port.fresh_cache(ids.shape[0])):
        feeds[n] = c.numpy()
    feeds.update(port.host_weights())
    return feeds


@pytest.mark.parametrize("quantize", ["int8", "q4_0"])
def test_c12_hidden_states_on_a_quantized_lm_head(models, quantize):  # noqa: F811
    ref, port = _pair(models, DType.F32, quantize)
    with pytest.raises(ValueError, match="lm_head activation"):
        ref.hidden_states(PROMPT)
    run = port._exec.graph
    head = next(n for n in run.nodes if run.outputs["logits"] in n.outputs)
    kind = {"int8": "QuantMatMul", "q4_0": "PackedMatMul"}[quantize]
    assert head.op.KIND == kind and port._hidden_tid() == head.inputs[0]
    hidden = port.hidden_states(PROMPT)
    L = PROMPT.shape[1]
    assert hidden.shape == (2, L, 256)
    # the tap in the port's own numpy evaluation of the same graph
    captured = {}
    run.eval(_host_feeds(port, PROMPT),
             capture=lambda tid, a: captured.setdefault(tid, a))
    _close(hidden, captured[head.inputs[0]][:, :L])
    # tap @ dequantized lm_head against the JAX package's logits
    name = next(n for n, t in run.inputs.items() if t == head.inputs[1])
    if quantize == "int8":
        w8, scale = port._quantized[name]
        w = w8.astype(np.float32) * scale
    else:
        w = dequant_repacked(port._packed[name])
    _close(hidden @ w, ref.logits(PROMPT), frac=1e-4)
    # and /v1/embeddings' pooling answers
    vecs = port.embed([PROMPT[0]])
    assert abs(np.linalg.norm(vecs[0]) - 1.0) < 1e-6


def test_beam_search_reports_the_teacher_forced_score(models):  # noqa: F811
    """return_scores: the best beams' summed log-probabilities, which a
    teacher-forced prefill over prompt and beam (sequence_scores, the
    mean over the 6 new tokens) gives back to 1e-5 relative at f32."""
    _, port = _pair(models, DType.F32, None)
    toks, score = port.beam_search_tokens(PROMPT, 6, beam=3,
                                          return_scores=True)
    np.testing.assert_array_equal(toks, port.beam_search_tokens(
        PROMPT, 6, beam=3))
    full = np.concatenate([PROMPT, toks], axis=1)
    L = PROMPT.shape[1]
    mean = port.sequence_scores(full, np.full(2, L), np.full(2, L + 6))
    np.testing.assert_allclose(mean * 6, score, rtol=1e-5)
