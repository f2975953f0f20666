"""The port's segmenter (pipeline/segmenter.py, CPU) against the JAX
package's: the merge/pad/window rules, multi-channel segmentation with
the energy detector and with PyanNet (one input at 8 kHz), a PyanNet
checkpoint file, the error contract (a failed channel is None and does
not shift the others), the VAD channel of a stereo input, and the
Darija converter on an xlsx the test writes. Segment times and
waveforms must be equal; the VAD probabilities under them agree to the
tolerances of tests/test_torch_vad.py."""

import jax
import numpy as np
import pytest
import torch

from audio_processor_tpu import config as jconfig
from audio_processor_tpu.models import vad as jv
from audio_processor_tpu.pipeline import segmenter as jseg
from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.dsp.resample import resample_np
from audio_processor_tpu_torch.models import vad as tv
from audio_processor_tpu_torch.pipeline import segmenter as tseg

from tests.test_torch_vad import pyannote_sd  # noqa: F401 (fixture)

SR = 16000
TINY = dict(sinc_filters=8, conv_channels=6, lstm_hidden=8,
            linear_hidden=8, lstm_layers=1, linear_layers=1)


def _pair(**settings):
    """The port's and the JAX segmenter on one configuration (energy
    VAD unless a checkpoint is configured); the port's on the CPU."""
    port = tseg.SpeechSegment(PipelineConfig(**settings), device="cpu")
    ref = jseg.SpeechSegment(jconfig.PipelineConfig(**settings))
    return port, ref


def _with_pyannet(port, ref, seed=0):
    """Both segmenters on one tiny PyanNet (the JAX init, converted)."""
    jcfg = jv.PyanNetConfig(**TINY)
    tree = jax.tree.map(np.asarray, jv.init_pyannet(
        jax.random.PRNGKey(seed), jcfg))
    tree["classifier"]["bias"] = np.full_like(tree["classifier"]["bias"],
                                              0.1)
    ref._vad_cfg, ref._vad_params = jcfg, tree
    tcfg = tv.PyanNetConfig(**TINY)
    model = tv.PyanNet(tcfg)
    model.load_state_dict(tv.params_from_jax(tree, tcfg))
    port._vad_cfg, port._vad_params = tcfg, model.eval()


def _channels(n, seed, sr=SR):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = (0.01 * rng.standard_normal(sr * (6 + i))).astype(np.float32)
        t = np.arange(sr * 2) / sr
        s = sr * (1 + i % 2)
        x[s:s + sr * 2] += (0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t)
                            ).astype(np.float32)
        out.append((x, "agent" if i % 2 == 0 else "client"))
    return out


def _assert_same_segments(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert [(s["start"], s["end"], s["speaker"]) for s in g] == \
            [(s["start"], s["end"], s["speaker"]) for s in w]
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a["segment_waveform"],
                                          b["segment_waveform"])


def test_merge_and_window_rules_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(30):
        edges = np.sort(rng.uniform(0, 60, 2 * int(rng.integers(0, 8))))
        tl = [(float(a), float(b)) for a, b in edges.reshape(-1, 2)]
        gap = float(rng.uniform(0, 2))
        assert tseg.merge_segments(tl, gap) == jseg.merge_segments(tl, gap)
        args = (60.0, tl, float(rng.uniform(0, 1)),
                float(rng.choice([0.05, 4.0, 25.0])), 0.5)
        assert tseg.extract_windows(*args) == jseg.extract_windows(*args)
    assert tseg.merge_segments([(0, 1), (1.8, 2)], 0.8) == [(0, 2)]
    assert tseg.extract_windows(60.0, [(5.0, 35.0)], 0.5, 25.0, 0.5) == \
        [(4.5, 29.5), (29.0, 35.5)]


@pytest.mark.parametrize("vad", ["energy", "pyannet"])
def test_multi_channel_segments_match_jax(vad):
    """Four channels through get_speech_segments_multi, then the same
    audio at 8 kHz (the energy detector runs at the input's rate;
    PyanNet resamples to its own)."""
    port, ref = _pair()
    if vad == "pyannet":
        _with_pyannet(port, ref)
    chans = _channels(4, 3)
    got = port.get_speech_segments_multi(chans, SR)
    _assert_same_segments(got, ref.get_speech_segments_multi(chans, SR))
    assert all(g for g in got)
    chans8 = [(resample_np(x[None], SR, 8000)[0], lab) for x, lab in chans]
    _assert_same_segments(port.get_speech_segments_multi(chans8, 8000),
                          ref.get_speech_segments_multi(chans8, 8000))


def test_checkpoint_file_engages_pyannet(pyannote_sd, tmp_path):  # noqa: F811
    """A pyannote checkpoint at vad_model_id becomes the VAD on both
    sides (num_outputs from the classifier); the segments agree. A
    missing file falls back to the energy detector."""
    ckpt = tmp_path / "pyannet.ckpt"
    torch.save({"state_dict": pyannote_sd}, ckpt)
    port, ref = _pair(vad_model_id=str(ckpt))
    assert port._vad_params is not None and ref._vad_params is not None
    assert port._vad_cfg.num_outputs == 3
    assert port._vad_params.classifier.weight.device.type == "cpu"
    chans = _channels(2, 4)
    _assert_same_segments(port.get_speech_segments_multi(chans, SR),
                          ref.get_speech_segments_multi(chans, SR))
    missing, _ = _pair(vad_model_id=str(tmp_path / "absent.ckpt"))
    assert missing._vad_params is None


def test_failed_channel_is_none_and_does_not_shift(monkeypatch):
    """A dispatch failure on channel 1 and a fetch failure on channel 3
    (where an asynchronous device error surfaces) give None for those
    channels only; the others keep their own audio."""
    port, _ = _pair()
    chans = _channels(4, 5)
    want = [port.get_speech_segments(w, SR, lab) for w, lab in chans]
    real_dispatch, real_fetch = port._vad_dispatch, port._vad_fetch
    calls = {"dispatch": 0, "fetch": 0}

    def dispatch(flat, rate):
        calls["dispatch"] += 1
        if calls["dispatch"] == 2:
            raise RuntimeError("synthetic dispatch error")
        return real_dispatch(flat, rate)

    def fetch(pending):
        calls["fetch"] += 1
        if calls["fetch"] == 3:          # the 4th channel's fetch
            raise RuntimeError("synthetic device error at fetch")
        return real_fetch(pending)

    monkeypatch.setattr(port, "_vad_dispatch", dispatch)
    monkeypatch.setattr(port, "_vad_fetch", fetch)
    got = port.get_speech_segments_multi(chans, SR)
    assert got[1] is None and got[3] is None
    _assert_same_segments([got[0], got[2]], [want[0], want[2]])
    assert got[0] and got[2]


def test_stereo_input_uses_the_vad_channel():
    t = np.arange(SR * 2) / SR
    x = np.zeros((2, SR * 6), np.float32)
    x[0, SR:SR * 3] = 0.4 * np.sin(2 * np.pi * 220 * t)
    x[1, SR:SR * 3] = 0.4 * np.sin(2 * np.pi * 330 * t)
    port, ref = _pair()
    segs = port.get_speech_segments(x, SR, "stereo")
    _assert_same_segments([segs], [ref.get_speech_segments(x, SR, "stereo")])
    assert segs
    for s in segs:
        wf = np.asarray(s["segment_waveform"])
        assert wf.shape[0] == 1
        start = int(s["start"] * SR)
        np.testing.assert_array_equal(wf[0], x[0, start:start + wf.shape[1]])


def test_darija_converter_matches_jax(tmp_path):
    from audio_processor_tpu.host.darija import DarijaFrenchConverter as J
    from audio_processor_tpu_torch.host.darija import DarijaFrenchConverter

    from tests.xlsx_writer import write_xlsx

    fr, nums = tmp_path / "fr.xlsx", tmp_path / "nums.xlsx"
    write_xlsx(fr, {"Sheet1": [["French", "Variante 1", "Variante 2"],
                               ["bonjour", "salam", "slm"],
                               ["merci", "chokran", None],
                               ["au revoir", "bslama", "b slama"]]})
    write_xlsx(nums, {"Sheet1": [["Nombre", "Variante 1", "Variante 2"],
                                 [1, "wahed", "wa7ed"], [2, "jouj", "zouj"],
                                 [12, "tnach", "tnache"]]})
    settings = dict(darija_french_dict=str(fr), darija_numbers_dict=str(nums))
    port = DarijaFrenchConverter(PipelineConfig(**settings))
    ref = J(jconfig.PipelineConfig(**settings))
    assert port.mapping == ref.mapping == {
        "salam": "bonjour", "slm": "bonjour", "chokran": "merci",
        "bslama": "au revoir", "b slama": "au revoir"}
    assert port.word_to_number == ref.word_to_number
    for text in ("salam khouya chokran", "wahed zouj telephone",
                 "wa7d tnache b slama", "SALAM  slm", ""):
        assert port.convert_text(text) == ref.convert_text(text), text
    assert port.convert_text("wahed zouj telephone").startswith("1 2 ")
