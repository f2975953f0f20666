"""Time-domain chunking of long calls (port of pipeline/chunker.py).

The host half of the reference's chunker, copied: fixed-duration
chunks (default 25 s) with a fixed overlap (default 1 s), a final
partial chunk, and the agent (channel 0) / client (channel 1) views
of a 2-channel call, the mixed view built lazily (``Chunk``,
``chunk_boundaries``, ``split_audio``); length buckets and dense
padded batches (``pick_bucket``, ``ChunkBatch``, ``chunk_batch``).
``prepare_and_split`` resamples through the port's numpy
``resample_np`` (the reference's numerics). ``StreamingChunker`` (the
incremental ``split_audio`` of the gRPC streaming RPC) and
``speaker_views`` are copied too.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from audio_processor_tpu_torch.dsp.resample import resample_np


class Chunk:
    """One chunk of one call, with the three speaker views.

    ``mixed`` (channel mean) is computed lazily: the fused device
    program builds the mixed view on the TPU from the raw agent/client
    rows, so the host only pays for it on the legacy (non-fused) path.
    """

    __slots__ = ("file_name", "chunk_idx", "start_time", "end_time",
                 "agent", "client", "meta", "_mixed")

    def __init__(self, file_name: str, chunk_idx: int, start_time: float,
                 end_time: float, mixed: np.ndarray = None,
                 agent: np.ndarray = None, client: np.ndarray = None,
                 meta: Dict = None):
        self.file_name = file_name
        self.chunk_idx = chunk_idx
        self.start_time = start_time
        self.end_time = end_time
        if agent is None:
            agent = mixed
        if client is None:
            client = agent
        self.agent = agent
        self.client = client
        self.meta = meta if meta is not None else {}
        self._mixed = mixed

    @property
    def mixed(self) -> np.ndarray:
        if self._mixed is None:
            if self.agent is self.client:
                self._mixed = self.agent
            else:
                self._mixed = ((self.agent + self.client) *
                               np.float32(0.5))
        return self._mixed

    @property
    def num_samples(self) -> int:
        return int(self.agent.shape[-1])


def chunk_boundaries(total_samples: int, chunk_samples: int,
                     step_samples: int) -> List[Tuple[int, int]]:
    """(start, end) sample offsets for every chunk.

    Mirrors the reference loop (audio_processor.py:133-158): starts at
    0, advances by ``step_samples``, stops once a chunk reaches the end
    of the signal. An empty signal yields no chunks.
    """
    if total_samples <= 0 or chunk_samples <= 0 or step_samples <= 0:
        return []
    bounds = []
    start = 0
    while start < total_samples:
        end = min(start + chunk_samples, total_samples)
        bounds.append((start, end))
        if end >= total_samples:
            break
        start += step_samples
    return bounds


class StreamingChunker:
    """Incremental ``split_audio``: feed [C, n] pieces as they arrive
    (live call audio), get back each Chunk the moment enough samples
    exist to complete it. Boundaries, indices and speaker views are
    byte-identical to a one-shot ``split_audio`` over the concatenated
    signal (property-tested), including the final-short-chunk and
    exact-end rules of ``chunk_boundaries``. Consumed audio before the
    next chunk start is discarded, so memory stays bounded by one
    chunk window regardless of call length."""

    def __init__(self, sample_rate: int, file_name: str = "stream",
                 chunk_duration_sec: float = 25.0,
                 overlap_sec: float = 1.0):
        self.sample_rate = sample_rate
        self.file_name = file_name
        self.chunk_samples = int(chunk_duration_sec * sample_rate)
        self.step_samples = self.chunk_samples - int(
            overlap_sec * sample_rate)
        if self.chunk_samples <= 0 or self.step_samples <= 0:
            raise ValueError("invalid chunk/overlap geometry")
        self._buf: np.ndarray | None = None   # [C, n] from _offset
        self._offset = 0                      # absolute pos of _buf[0]
        self._total = 0
        self._idx = 0
        self._last_end = -1                   # end of last emitted chunk
        self._flushed = False

    def _emit(self, start: int, end: int) -> Chunk:
        lo, hi = start - self._offset, end - self._offset
        agent = self._buf[0, lo:hi]
        client = self._buf[1 if self._buf.shape[0] == 2 else 0, lo:hi]
        c = Chunk(file_name=self.file_name, chunk_idx=self._idx,
                  start_time=start / self.sample_rate,
                  end_time=end / self.sample_rate,
                  agent=np.ascontiguousarray(agent),
                  client=np.ascontiguousarray(client))
        self._idx += 1
        return c

    def _next_start(self) -> int:
        return self._idx * self.step_samples

    def _trim(self) -> None:
        keep_from = self._next_start()
        if keep_from > self._offset:
            self._buf = self._buf[:, keep_from - self._offset:]
            self._offset = keep_from

    def feed(self, piece: np.ndarray) -> List[Chunk]:
        piece = np.asarray(piece, np.float32)
        if piece.ndim == 1:
            piece = piece[None, :]
        if piece.shape[-1] == 0:
            return []
        if self._buf is None:
            self._buf = piece
        else:
            if piece.shape[0] != self._buf.shape[0]:
                raise ValueError("channel count changed mid-stream")
            self._buf = np.concatenate([self._buf, piece], axis=1)
        self._total += piece.shape[-1]
        out: List[Chunk] = []
        while self._next_start() + self.chunk_samples <= self._total:
            start = self._next_start()
            end = start + self.chunk_samples
            out.append(self._emit(start, end))
            self._last_end = end
            self._trim()
        return out

    def flush(self) -> List[Chunk]:
        """End of stream: the trailing short chunk, if any (none when
        the last full chunk ended exactly at the stream end —
        chunk_boundaries' break rule)."""
        if self._flushed or self._total == 0 \
                or self._last_end == self._total \
                or self._next_start() >= self._total:
            self._flushed = True
            return []
        out = [self._emit(self._next_start(), self._total)]
        self._flushed = True
        return out


def speaker_views(waveform: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mixed, agent, client) views of a [C, T] waveform.

    2-channel: agent = ch0, client = ch1, mixed = mean (reference:
    audio_processor.py:122-131). Mono: all three alias the input.
    """
    waveform = np.asarray(waveform)
    if waveform.ndim == 1:
        waveform = waveform[None, :]
    if waveform.shape[0] == 2:
        agent = waveform[0]
        client = waveform[1]
        mixed = waveform.mean(axis=0)
    else:
        agent = client = mixed = waveform[0]
    return mixed.astype(np.float32), agent.astype(np.float32), client.astype(np.float32)


def prepare_and_split(waveform: np.ndarray, sample_rate: int,
                      file_name: str, config
                      ) -> Tuple[np.ndarray, int, List[Chunk]]:
    """Decoded audio -> (waveform, rate, chunks) under the pipeline's
    config: resample to target_sample_rate, truncate at
    max_audio_length, split into overlapping chunks."""
    target_sr = int(config.get("target_sample_rate", 16000))
    if sample_rate != target_sr:
        waveform = resample_np(waveform, sample_rate, target_sr)
        sample_rate = target_sr
    max_len = int(float(config.get("max_audio_length", 1800.0))
                  * sample_rate)
    if waveform.shape[-1] > max_len:
        waveform = waveform[..., :max_len]
    chunks = split_audio(
        waveform, sample_rate, file_name,
        float(config.get("chunk_duration_sec", 25.0)),
        float(config.get("overlap_sec", 1.0)))
    return waveform, sample_rate, chunks


def split_audio(waveform: np.ndarray, sample_rate: int, file_name: str,
                chunk_duration_sec: float = 25.0,
                overlap_sec: float = 1.0) -> List[Chunk]:
    """Split one call into overlapping chunks with speaker views."""
    chunk_samples = int(chunk_duration_sec * sample_rate)
    overlap_samples = int(overlap_sec * sample_rate)
    step_samples = chunk_samples - overlap_samples
    waveform = np.asarray(waveform)
    if waveform.ndim == 1:
        waveform = waveform[None, :]
    waveform = waveform.astype(np.float32, copy=False)
    # Same channel semantics as speaker_views (2-channel -> agent/
    # client; anything else -> mono ch0), but without computing the
    # mixed view — Chunk builds it lazily / the fused program builds
    # it on device.
    if waveform.shape[0] == 2:
        agent, client = waveform[0], waveform[1]
    else:
        agent = client = waveform[0]
    out: List[Chunk] = []
    for idx, (s, e) in enumerate(
            chunk_boundaries(agent.shape[-1], chunk_samples, step_samples)):
        out.append(Chunk(
            file_name=file_name,
            chunk_idx=idx,
            start_time=s / sample_rate,
            end_time=e / sample_rate,
            agent=agent[s:e],    # contiguous views, no copies: the
            client=client[s:e],  # mixed view is built on device
        ))
    return out


def pick_bucket(num_samples: int, bucket_samples: Sequence[int]) -> int:
    """Smallest bucket >= num_samples (largest bucket if none fits)."""
    for b in bucket_samples:
        if num_samples <= b:
            return b
    return max(bucket_samples)


class ChunkBatch:
    """Dense, statically-shaped batch of chunks for one bucket.

    ``audio`` is [N, 3, L]: the three speaker views stacked so one
    device program transcribes mixed/agent/client in a single batched
    forward pass (vs the reference's 3 sequential forwards,
    audio_processor.py:269-272). It is built lazily — the fused engine
    path uploads raw agent/client rows and never touches it, saving a
    ~[N, 3, L] host allocation + copy per batch.
    """

    def __init__(self, lengths: np.ndarray, bucket_len: int,
                 chunks: List[Chunk], audio: np.ndarray = None):
        self.lengths = lengths          # [N] int32 valid samples
        self.bucket_len = bucket_len
        self.chunks = chunks            # originating metadata, len N
        self._audio = audio

    @property
    def audio(self) -> np.ndarray:      # [N, 3, L] float32, zero-padded
        if self._audio is None:
            n, L = len(self.chunks), self.bucket_len
            audio = np.zeros((n, 3, L), dtype=np.float32)
            for i, c in enumerate(self.chunks):
                t = int(self.lengths[i])
                audio[i, 0, :t] = c.mixed[:t]
                audio[i, 1, :t] = c.agent[:t]
                audio[i, 2, :t] = c.client[:t]
            self._audio = audio
        return self._audio

    def __len__(self) -> int:
        return len(self.chunks)


def chunk_batch(chunks: Sequence[Chunk], bucket_samples: Sequence[int],
                sort_by_length: bool = True) -> List[ChunkBatch]:
    """Group chunks by length bucket into dense padded batches.

    Length bucketing replaces the reference's dynamic sort+pad
    (audio_processor.py:171-175, 253-261): each bucket has one static
    padded length, so XLA compiles one program per bucket instead of
    recompiling per batch shape.
    """
    if not chunks:
        return []
    by_bucket: Dict[int, List[Chunk]] = {}
    for c in chunks:
        b = pick_bucket(c.num_samples, bucket_samples)
        by_bucket.setdefault(b, []).append(c)

    batches = []
    for bucket_len in sorted(by_bucket):
        group = by_bucket[bucket_len]
        if sort_by_length:
            group = sorted(group, key=lambda c: c.num_samples)
        lengths = np.array([min(c.num_samples, bucket_len)
                            for c in group], dtype=np.int32)
        batches.append(ChunkBatch(lengths=lengths, bucket_len=bucket_len,
                                  chunks=list(group)))
    return batches
