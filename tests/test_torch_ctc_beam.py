"""The port's CTC prefix beam search (models/ctc_beam.py, a numpy copy
holding the port's CTCVocab) against the JAX package's, and the
engine's beam path: ``beam_width > 1`` decodes the mono program's log
posteriors, which match the JAX ``_logits_fn``'s (fp32, atol 1e-4, the
bound of tests/test_torch_wav2vec2bert.py), with ``ctc_beam_search``."""

import numpy as np
import pytest
import torch

from audio_processor_tpu.models import ctc_beam as jbeam
from audio_processor_tpu.models.tokenizer import CTCVocab as JaxVocab
from audio_processor_tpu_torch.models import ctc_beam as tbeam
from audio_processor_tpu_torch.models.tokenizer import CTCVocab

from tests.conftest import make_stereo_call
from tests.test_torch_message_path import tiny_pair

SCORE_TOL = 1e-9
LOGP_ATOL = 1e-4


def _log_probs(rng, T, V):
    logits = rng.standard_normal((T, V)) * 2.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return np.log(e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed, beam, bonus", [
    (0, 4, 0.0), (1, 8, 0.7), (2, 16, -0.3)])
def test_beam_search_matches_jax(seed, beam, bonus):
    """Every hypothesis, in order, with its score within 1e-9, on the
    Darija vocabulary with a ragged mask and a word bonus."""
    vocab, jvocab = CTCVocab.darija_default(), JaxVocab.darija_default()
    rng = np.random.default_rng(seed)
    lp = _log_probs(rng, 40, len(vocab))
    lp[:, vocab.vocab["|"]] += 1.0          # words to give a bonus to
    mask = rng.uniform(size=40) > 0.2
    got = tbeam.ctc_beam_search(lp, vocab, beam_width=beam,
                                word_bonus=bonus, mask=mask)
    want = jbeam.ctc_beam_search(lp, jvocab, beam_width=beam,
                                 word_bonus=bonus, mask=mask)
    assert [t for t, _ in got] == [t for t, _ in want] and len(got) > 1
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=SCORE_TOL, rtol=0)


def test_batch_beam_decode_matches_jax():
    vocab = CTCVocab({"<pad>": 0, "|": 1, "a": 2, "b": 3})
    jvocab = JaxVocab({"<pad>": 0, "|": 1, "a": 2, "b": 3})
    logits = np.random.default_rng(0).standard_normal((3, 9, 4)).astype(
        np.float32)
    mask = np.ones((3, 9), bool)
    mask[1, 5:] = False
    assert tbeam.batch_beam_decode(logits, vocab, mask=mask, beam_width=8) \
        == jbeam.batch_beam_decode(logits, jvocab, mask=mask, beam_width=8)


def test_engine_beam_path_matches_its_posteriors_and_jax():
    """transcribe_mono_segments under beam_width 4 returns
    ctc_beam_search of the engine's own log posteriors, and those match
    the JAX mono program's on every valid frame."""
    jeng, teng = tiny_pair(beam_width=4, beam_word_bonus=0.25)
    assert (teng.beam_width, teng.beam_word_bonus) == (4, 0.25)
    rng = np.random.default_rng(3)
    waves = [make_stereo_call(dur=d)[i % 2]
             + 0.05 * rng.standard_normal(int(16000 * d)).astype(np.float32)
             for i, d in enumerate((1.5, 3.5, 2.2))]
    texts = teng.transcribe_mono_segments(waves)
    assert teng.mono_dispatches == 2            # buckets 2 s and 4 s
    assert all(isinstance(t, str) for t in texts) and any(texts)

    from audio_processor_tpu_torch.pipeline.chunker import Chunk, chunk_batch

    chunks = [Chunk("", i, 0.0, 0.0, mixed=w) for i, w in enumerate(waves)]
    expect = {}
    for batch in chunk_batch(chunks, teng.bucket_samples):
        rows = batch.audio[:, 0, :]
        n_dev = teng._row_tail_size(len(batch))
        pad = n_dev - len(batch)
        rows = np.concatenate([rows, np.zeros((pad, batch.bucket_len),
                                              np.float32)])
        lens = np.concatenate([batch.lengths,
                               np.full(pad, batch.bucket_len, np.int32)])
        lp, mask = (t.numpy() for t in teng._mono(
            torch.from_numpy(rows), torch.from_numpy(lens), beam=True))
        jlp, jmask = (np.asarray(a) for a in jeng._logits_fn(
            batch.bucket_len)(jeng.params, rows, lens))
        np.testing.assert_array_equal(mask, jmask)
        # Padding rows (zero audio) are arbitrary on both sides: the
        # frontend normalizes a constant signal.
        real = slice(0, len(batch))
        np.testing.assert_allclose(lp[real][mask[real]],
                                   jlp[real][mask[real]], atol=LOGP_ATOL,
                                   rtol=0)
        for j, c in enumerate(batch.chunks):
            expect[c.chunk_idx] = tbeam.ctc_beam_search(
                lp[j], teng.vocab, beam_width=4, word_bonus=0.25,
                mask=mask[j].astype(bool))[0][0]
    assert texts == [expect[i] for i in range(len(waves))]
