"""VAD-driven speech segmentation + mono transcription (port of
pipeline/segmenter.py; the message path).

VAD timeline -> merge segments with gaps <= ``vad_gap_threshold`` ->
pad +-``vad_padding`` -> window long segments into
<= ``vad_max_segment_sec`` pieces with ``vad_window_overlap_sec``
overlap -> batched CTC transcription (the engine's mono-rows program)
-> text cleaning (+ optional Darija conversion).

The VAD (models/vad.py) runs on the engine's device, or on the device
passed in (default ``cuda``); ``vad_device`` is not read, as in the
reference. ``vad_model_id`` names a local ``torch.load`` file holding a
pyannote-layout PyanNet state dict; without one the energy detector
runs.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from audio_processor_tpu_torch.dsp.resample import resample_np
from audio_processor_tpu_torch.io.wire import upload
from audio_processor_tpu_torch.models import vad as vad_mod
from audio_processor_tpu_torch.utils.text import remove_special_characters

logger = logging.getLogger(__name__)


def merge_segments(timeline: List[Tuple[float, float]],
                   gap_threshold: float) -> List[Tuple[float, float]]:
    """Merge segments closer than gap_threshold
    (reference: speech_segment.py:366-383)."""
    if not timeline:
        return []
    merged = []
    cur_start, cur_end = timeline[0]
    for start, end in timeline[1:]:
        if start - cur_end <= gap_threshold:
            cur_end = end
        else:
            merged.append((cur_start, cur_end))
            cur_start, cur_end = start, end
    merged.append((cur_start, cur_end))
    return merged


def extract_windows(total_duration: float,
                    segments: List[Tuple[float, float]],
                    padding: float, max_len_sec: float,
                    overlap: float) -> List[Tuple[float, float]]:
    """Pad and window segments (reference: speech_segment.py:385-418).
    Returns (start_sec, end_sec) windows."""
    out = []
    for start, end in segments:
        padded_start = max(0.0, start - padding)
        padded_end = min(total_duration, end + padding)
        cur = padded_start
        while cur < padded_end:
            win_end = min(padded_end, cur + max_len_sec)
            out.append((cur, win_end))
            if win_end >= padded_end:
                break
            cur = max(cur + max_len_sec - overlap, cur + 0.1)
    return out


class SpeechSegment:
    """VAD + segmentation + batched mono transcription facade.

    ``_vad_params`` holds the loaded :class:`~..models.vad.PyanNet` on
    the device (None: the energy detector runs)."""

    def __init__(self, config, asr_engine=None, converter=None,
                 device=None):
        self.config = config
        self.asr_engine = asr_engine
        self.converter = converter
        if device is None:
            device = (asr_engine.device if asr_engine is not None
                      else "cuda")
        self.device = torch.device(device)
        self._vad_params = None
        self._vad_cfg = None
        self._load_vad()

    def _load_vad(self):
        """Load a PyanNet checkpoint when configured; otherwise use the
        deterministic energy detector."""
        model_path = self.config.get("vad_model_id", "") or ""
        if model_path and Path(model_path).exists():
            try:
                # A pyannote Lightning checkpoint pickles more than
                # tensors, as the reference's loader accepts.
                sd = torch.load(model_path, map_location="cpu",
                                weights_only=False)
                if isinstance(sd, dict) and "state_dict" in sd:
                    sd = sd["state_dict"]
                # Multi-speaker segmentation checkpoints (pyannote's
                # VAD pipeline model) have >1 output; infer from the
                # classifier head and reduce with max like the pipeline.
                n_out = int(sd["classifier.bias"].shape[0]) \
                    if "classifier.bias" in sd else 1
                n_lin = 0
                while f"linear.{n_lin}.weight" in sd:
                    n_lin += 1
                cfg = vad_mod.PyanNetConfig(num_outputs=n_out,
                                            linear_layers=n_lin)
                model = vad_mod.PyanNet(cfg)
                model.load_state_dict(vad_mod.convert_pyannet(sd, cfg))
                self._vad_params = model.to(self.device).eval()
                self._vad_cfg = cfg
                logger.info("Loaded PyanNet VAD from %s", model_path)
                return
            except Exception as e:
                logger.error("Failed to load VAD checkpoint %s: %s "
                             "- falling back to energy VAD",
                             model_path, e)
        logger.info("Using energy VAD (no PyanNet checkpoint configured)")

    # ------------------------------------------------------------------
    def _vad_dispatch(self, flat: np.ndarray, sample_rate: int):
        """Enqueue one channel's VAD on the device without fetching.
        Returns an opaque pending handle for :meth:`_vad_fetch`."""
        if self._vad_params is not None:
            # PyanNet's windows/hop are sized in model samples; audio
            # at any other rate is resampled for the VAD pass (segment
            # TIMES stay in true seconds either way, and
            # _segments_from_probs slices the original-rate audio).
            model_sr = int(self._vad_cfg.sample_rate)
            if sample_rate != model_sr:
                flat = resample_np(flat[None, :], sample_rate, model_sr)[0]
            return ("pyannet", vad_mod.pyannet_windowed_dispatch(
                self._vad_params, flat,
                window_sec=float(
                    self.config.get("vad_infer_window_sec", 5.0)),
                step_sec=float(
                    self.config.get("vad_infer_step_sec", 2.5)),
                batch_rows=int(
                    self.config.get("vad_infer_batch_rows", 16))))
        x = np.ascontiguousarray(flat[None, :], np.float32)
        lengths = np.array([flat.shape[0]], np.int32)
        return ("energy", (vad_mod.energy_vad_probs(
            upload(x, self.device), upload(lengths, self.device)),
            sample_rate))

    def _vad_fetch(self, pending) -> Tuple[np.ndarray, float]:
        kind, payload = pending
        if kind == "pyannet":
            return (vad_mod.pyannet_windowed_fetch(payload),
                    vad_mod.pyannet_frame_hop_sec(self._vad_cfg))
        (probs, _mask), sample_rate = payload
        return probs.cpu().numpy()[0], vad_mod.HOP / sample_rate

    def vad_probs(self, waveform: np.ndarray, sample_rate: int
                  ) -> Tuple[np.ndarray, float]:
        """Mono waveform -> (frame speech probs, frame hop seconds)."""
        mono = np.asarray(waveform, np.float32).reshape(-1)
        return self._vad_fetch(self._vad_dispatch(mono, sample_rate))

    def _segments_from_probs(self, probs: np.ndarray, hop_sec: float,
                             mono: np.ndarray, sample_rate: int,
                             speaker_label: str) -> List[Dict[str, Any]]:
        """binarize -> merge -> pad/window -> segment dicts (host)."""
        timeline = vad_mod.binarize(
            probs, hop_sec,
            onset=float(self.config.get("vad_onset", 0.5)),
            offset=float(self.config.get("vad_offset", 0.5)),
            min_duration_on=float(
                self.config.get("vad_min_duration_on", 0.0)),
            min_duration_off=float(
                self.config.get("vad_min_duration_off", 0.0)))
        if not timeline:
            logger.warning("No speech segments found for %s",
                           speaker_label)
            return []
        merged = merge_segments(
            timeline, float(self.config.get("vad_gap_threshold", 0.8)))
        total_duration = mono.shape[1] / sample_rate
        windows = extract_windows(
            total_duration, merged,
            padding=float(self.config.get("vad_padding", 0.5)),
            max_len_sec=float(
                self.config.get("vad_max_segment_sec", 25.0)),
            overlap=float(
                self.config.get("vad_window_overlap_sec", 0.5)))
        out = []
        for start, end in windows:
            s = int(start * sample_rate)
            e = int(end * sample_rate)
            out.append({
                # The channel the VAD ran on (channel 0): keeping all
                # channels of a multi-channel input would make the
                # batched flatten concatenate them into one wave.
                "segment_waveform": mono[:1, s:e],
                "start": start,
                "end": end,
                "speaker": speaker_label,
            })
        return out

    @staticmethod
    def _as_mono2d(waveform: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        mono = np.asarray(waveform, np.float32)
        if mono.ndim == 2:
            return mono, mono[0]
        return mono[None, :], mono

    def get_speech_segments(self, waveform: np.ndarray, sample_rate: int,
                            speaker_label: str) -> List[Dict[str, Any]]:
        """VAD -> merge -> pad/window -> extracted segment dicts
        (reference contract: speech_segment.py:292-418)."""
        try:
            mono, flat = self._as_mono2d(waveform)
            probs, hop_sec = self._vad_fetch(
                self._vad_dispatch(flat, sample_rate))
            return self._segments_from_probs(probs, hop_sec, mono,
                                             sample_rate, speaker_label)
        except Exception as e:
            logger.error("Error in speech segmentation: %s", e)
            return []

    def get_speech_segments_multi(
            self, channels: List[Tuple[np.ndarray, str]],
            sample_rate: int) -> List[Optional[List[Dict[str, Any]]]]:
        """Segment MANY channels with overlapped device work: every
        channel's VAD is enqueued before any result is fetched.

        ``channels``: [(waveform, speaker_label), ...]. Returns one
        entry per channel: a segment list ([] = genuinely no speech),
        or None for a channel whose segmentation FAILED — at dispatch,
        or at fetch, where an error in the asynchronous device work
        surfaces. Callers must not treat an error like silence (the
        engine's idempotent message refresh would wipe a call's rows).
        """
        pendings = []
        monos = []
        for waveform, label in channels:
            # One append per list per channel: a dispatch exception must
            # not leave monos one entry longer than pendings, or every
            # later channel pairs with the previous channel's audio.
            try:
                mono, flat = self._as_mono2d(waveform)
                pending = self._vad_dispatch(flat, sample_rate)
            except Exception as e:
                logger.error("Error dispatching VAD for %s: %s",
                             label, e)
                mono, pending = None, None
            monos.append(mono)
            pendings.append(pending)
        out: List[Optional[List[Dict[str, Any]]]] = []
        for (waveform, label), mono, pending in zip(channels, monos,
                                                    pendings):
            if pending is None:
                out.append(None)
                continue
            try:
                probs, hop_sec = self._vad_fetch(pending)
                out.append(self._segments_from_probs(
                    probs, hop_sec, mono, sample_rate, label))
            except Exception as e:
                logger.error("Error in speech segmentation for %s: %s",
                             label, e)
                out.append(None)
        return out

    def transcribe_segments_batched(self, segments: List[Dict[str, Any]],
                                    sample_rate: int
                                    ) -> List[Dict[str, Any]]:
        """Batched CTC transcription of segments, preserving order
        (reference: speech_segment.py:190-290)."""
        if not segments:
            return []
        if self.asr_engine is None:
            raise RuntimeError("SpeechSegment has no ASR engine attached")
        waves = [np.asarray(s["segment_waveform"]).reshape(-1)
                 for s in segments]
        texts = self.asr_engine.transcribe_mono_segments(waves)
        out = []
        for seg, text in zip(segments, texts):
            cleaned = remove_special_characters(text or "")
            if self.converter is not None:
                try:
                    cleaned = self.converter.convert_text(cleaned)
                except Exception:
                    pass
            out.append({**seg, "text": cleaned.strip()})
        return out


class SpeechBatchTranscriber:
    """Reference public API (speech_segment.py:420-427)."""

    def __init__(self, config, asr_engine=None, converter=None,
                 device=None):
        self.segmenter = SpeechSegment(config, asr_engine=asr_engine,
                                       converter=converter, device=device)

    def transcribe_mono(self, waveform, sample_rate: int,
                        speaker_label: str = "unknown"
                        ) -> List[Dict[str, Any]]:
        segments = self.segmenter.get_speech_segments(
            waveform, sample_rate, speaker_label)
        return self.segmenter.transcribe_segments_batched(
            segments, sample_rate)
