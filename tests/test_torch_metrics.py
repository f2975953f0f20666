"""The port's WER/CER metrics (utils/metrics.py) equal the JAX package's
exactly: on the hand-computed cases of tests/test_metrics.py and on
seeded random sequences."""

import numpy as np
import pytest

from audio_processor_tpu.utils import metrics as jm
from audio_processor_tpu_torch.utils import metrics as tm


def test_edit_distance_equals_jax_on_random_sequences():
    rng = np.random.default_rng(0)
    for _ in range(200):
        a = "".join(rng.choice(list("abcde "), rng.integers(0, 30)))
        b = "".join(rng.choice(list("abcde "), rng.integers(0, 30)))
        assert tm.edit_distance(a, b) == jm.edit_distance(a, b)
        ta, tb = a.split(), b.split()
        assert tm.edit_distance(ta, tb) == jm.edit_distance(ta, tb)


@pytest.mark.parametrize("ref,hyp", [
    ([], []), (["a"], []), ([], ["a", "b"]), ("kitten", "sitting"),
    (["the", "cat"], ["the", "hat"]), ([1, 2, 3], [1, 3]),
])
def test_edit_distance_hand_cases(ref, hyp):
    assert tm.edit_distance(ref, hyp) == jm.edit_distance(ref, hyp)


def test_wer_cer_hand_cases():
    cases = [
        (["the cat sat down"], ["the hat sat"]),
        (["a b"], ["a b"]),
        (["a b c d e f g h i j", "x"], ["a b c d e f g h i j", "y"]),
        (["ab  cd"], ["ab cd"]),
        (["abc"], ["abd"]),
        ([""], [""]),
        ([""], ["x"]),            # inf: insertions over no reference
    ]
    for refs, hyps in cases:
        assert tm.wer(refs, hyps) == jm.wer(refs, hyps), (refs, hyps)
        assert tm.cer(refs, hyps) == jm.cer(refs, hyps), (refs, hyps)


def test_wer_cer_equal_jax_on_random_corpora():
    rng = np.random.default_rng(1)
    words = ["salam", "labas", "wakha", "bzaf", "shukran", "ah", "la"]
    for _ in range(20):
        n = int(rng.integers(1, 6))
        refs = [" ".join(rng.choice(words, rng.integers(0, 8)))
                for _ in range(n)]
        hyps = [" ".join(rng.choice(words, rng.integers(0, 8)))
                for _ in range(n)]
        assert tm.wer(refs, hyps) == jm.wer(refs, hyps)
        assert tm.cer(refs, hyps) == jm.cer(refs, hyps)


@pytest.mark.parametrize("fn", ["wer", "cer"])
def test_mismatched_lengths_raise(fn):
    with pytest.raises(ValueError):
        getattr(tm, fn)(["a"], ["a", "b"])
