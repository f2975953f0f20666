"""The port's ``AudioProcessor`` facade (pipeline/facades.py) against the
JAX package's, on the cases of tests/test_facades.py: both facades on
one set of tiny fp32 weights (the port's on the CPU), same audio, same
dicts out (waveforms equal, transcripts equal)."""

import difflib
import importlib.util
import pathlib

import numpy as np
import pytest

from audio_processor_tpu import config as jconfig
from audio_processor_tpu.pipeline.facades import AudioProcessor as JaxFacade
from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.io import wav
from audio_processor_tpu_torch.pipeline.facades import AudioProcessor

from tests.test_torch_message_path import SETTINGS, tiny_pair

KEYS = ("transcription_chunk", "agent_transcription", "client_transcription",
        "error")


@pytest.fixture
def facades():
    jeng, teng = tiny_pair()
    port = AudioProcessor(PipelineConfig.from_dict(SETTINGS), device="cpu")
    ref = JaxFacade(jconfig.PipelineConfig.from_dict(SETTINGS))
    port.engine, ref.engine = teng, jeng
    return port, ref


def _same_chunks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(g[k], v)
            else:
                assert g[k] == v, k


def test_default_device_is_cuda():
    assert AudioProcessor(PipelineConfig()).device.type == "cuda"


def test_load_and_split_match_jax(facades, tmp_path, stereo_call):
    """load_audio, split_audio's chunk dicts and speaker channels, and
    the resampling of an 8 kHz input, equal the JAX facade's."""
    port, ref = facades
    p = tmp_path / "c.wav"
    wav.write(p, stereo_call, 16000)
    (w, sr), (jw, jsr) = port.load_audio(p), ref.load_audio(p)
    assert sr == jsr == 16000
    np.testing.assert_array_equal(w, jw)
    for wave, rate in ((stereo_call, 16000), (0.1 * np.random.default_rng(
            0).standard_normal((2, 16000)).astype(np.float32), 8000)):
        got, want = (f.split_audio(wave, rate, "c.wav") for f in facades)
        _same_chunks(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        port.get_resampler(8000, 16000)(stereo_call[:, :8000]),
        ref.get_resampler(8000, 16000)(stereo_call[:, :8000]))


def test_transcribe_batch_matches_jax(facades, stereo_call):
    port, ref = facades
    chunks, _, _ = port.split_audio(stereo_call, 16000, "c.wav")
    jchunks, _, _ = ref.split_audio(stereo_call, 16000, "c.wav")
    out, jout = port.transcribe_batch(chunks), ref.transcribe_batch(jchunks)
    assert out is chunks                   # in-place contract
    for g, w in zip(out, jout):
        assert [g[k] for k in KEYS] == [w[k] for k in KEYS]
        assert g["error"] == ""


def test_process_batch_and_failed_files_match_jax(facades, tmp_path,
                                                  stereo_call):
    port, ref = facades
    good = tmp_path / "good.wav"
    wav.write(good, stereo_call, 16000)
    missing = tmp_path / "missing.wav"
    got = port.process_batch(0, [good, missing])
    want = ref.process_batch(0, [good, missing])
    assert len(got) == len(want) >= 1
    assert all(r["file_name"] == "good.wav" for r in got)
    for g, w in zip(got, want):
        assert [g[k] for k in KEYS] == [w[k] for k in KEYS]
    assert [f["filename"] for f in port.failed_files] == \
        [f["filename"] for f in ref.failed_files] == ["missing.wav"]


def test_db_call_row_matches_jax(facades, tmp_path, stereo_call):
    class FakeDB:
        def __init__(self):
            self.calls = []

        def insert_call(self, data):
            self.calls.append(data)

    p = tmp_path / "call9.wav"
    wav.write(p, stereo_call, 16000)
    rows = []
    for f in facades:
        f.db_manager = FakeDB()
        f._process_single_file(p)
        rows.append(f.db_manager.calls)
    assert rows[0] == rows[1]
    assert rows[0][0]["id_enregistrement"] == "call9"
    assert rows[0][0]["duration_seconds"] == pytest.approx(10.0, abs=0.01)


def test_ogg_through_facade_matches_jax(facades):
    """A real Vorbis file (pygame's example, mono at 11025 Hz) through
    decode, resample to 16 kHz, chunking and transcription."""
    spec = importlib.util.find_spec("pygame")
    ogg = (pathlib.Path(spec.origin).parent / "examples" / "data"
           / "house_lo.ogg") if spec else None
    if ogg is None or not ogg.exists():
        pytest.skip("no ogg sample")
    got, want = (f.process_batch(0, [ogg]) for f in facades)
    assert len(got) == len(want) == 3
    assert all(r["error"] == "" for r in got)
    for g, w in zip(got, want):
        for k in ("chunk_idx", "start_time", "end_time", "file_name"):
            assert g[k] == w[k]
        # The JAX package decodes Vorbis with its native library, the
        # port here with the same decoder's Python half (its native
        # library is built only beside the CUDA kernels): the float
        # samples differ by < 1e-6.
        for k in ("agent_waveform", "client_waveform"):
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0)
        # Those differences move near-tied frames of the random tiny
        # model: transcripts agree to 99% of their characters.
        for k in KEYS[:3]:
            assert difflib.SequenceMatcher(None, g[k], w[k]).ratio() \
                >= 0.99, (k, g[k], w[k])
