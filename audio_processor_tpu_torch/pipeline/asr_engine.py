"""ASR engine: chunks -> transcripts (port of pipeline/asr_engine.py).

One fused device program per chunk batch, as in the reference's
``ASREngine._fused_fn``: a single upload of the two raw channels
(reflect-pre-padded, int16 on the wire) feeds the mixed/agent/client
rows, the fbank frontend, the Wav2Vec2Bert encoder for all three views,
greedy CTC ids, and the 38 acoustic sentiment features.

Kept from the reference: static length buckets, power-of-two tail
batches, and the dispatch/fetch split (:meth:`dispatch_chunks` enqueues
every sub-batch on the device and returns a closure that fetches and
decodes, so the pipeline overlaps batch N+1's device work with batch
N's host work; CUDA launches are asynchronous like JAX dispatch). The
encoder replays a CUDA graph per shape (models/cuda_graphs.py), so
enqueueing takes far less time than the card runs; the engine keeps at
most ``PACE_DEPTH`` device batches queued behind the one running, so a
sweep cannot run ahead of the card by more than that. The batches run on
a stream of the engine's own per device, so the process's other device
work (the analysis stage's classifiers, the message path) neither queues
behind them nor holds them up.

The mono-rows program (:meth:`ASREngine._mono`, the reference's
``_mono_fn``) transcribes [N, L] rows of one view: the VAD segments of
the message path (:meth:`transcribe_mono_segments`, every bucket
dispatched before any fetch, 12/24/48-row tails; greedy ids, or log
posteriors decoded by CTC prefix beam search when ``beam_width > 1``),
and the three views of each chunk under ``fuse_acoustic_features:
false`` (no acoustic features then, as in the reference).

The speech-to-text model (``asr_model_type: seamless_m4t_v2_s2t``,
models/seamless_s2t.py) runs in the same fused program: the speech encoder
and its length adaptor in place of the CTC encoder, then the text decoder's
greedy loop to each row's cap (``s2t_max_new_tokens``, ``s2t_len_a``,
``s2t_len_b``) after the prompt ``</s>`` + ``s2t_tgt_lang_id``. Its output
is token ids and the mask of each row's text tokens; the fetch turns them
into text through the piece table. It has no mono-rows program, so the
message path, serving, unfused features and word timestamps refuse it.

Weights: an HF checkpoint directory when ``transcription_model`` points
at one (models/checkpoint.py: converted once, then restored from its
``torch_converted/`` cache), else seeded random weights with the default
Darija vocabulary (synthetic mode, logged). ``quantization: int8`` runs
the encoder's dense layers as W8A8 (models/quant.py), on a loaded or a
given model alike.

With a mesh (parallel/mesh.py) of ``data`` devices in one process the
engine keeps one replica of the model per 'data' device (the first along
'seq' and 'model', which the reference's engine replicates over): it
scales ``device_chunks`` by ``data``, splits each padded device batch into
``data`` equal slices, runs each slice on its replica and concatenates
the rows on the host, so the rows equal the one-device engine's. The
mono-rows programs run on the first replica. A mesh of processes gives
this process one replica on its own device; the calls are split across
processes by ``owns_call`` (pipeline/engine.py).
"""

from __future__ import annotations

import contextlib
import copy
import logging
import threading
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from audio_processor_tpu_torch.dsp.acoustic_features import (
    PAD, extract_features_batch, prepare_reflect_padded,
)
from audio_processor_tpu_torch.dsp.fbank import (
    HOP_LENGTH, STRIDE, log_mel_frontend,
)
from audio_processor_tpu_torch.io import native
from audio_processor_tpu_torch.io.wire import maybe_int16_wire, upload
from audio_processor_tpu_torch.models import seamless_s2t as s2t
from audio_processor_tpu_torch.models import wav2vec2bert as w2v
from audio_processor_tpu_torch.models.ctc_beam import ctc_beam_search
from audio_processor_tpu_torch.models.checkpoint import (
    load_or_convert_w2v_bert,
)
from audio_processor_tpu_torch.models.pieces import PieceVocab
from audio_processor_tpu_torch.models.tokenizer import (
    CTCVocab, batch_decode, decode_words,
)
from audio_processor_tpu_torch.obs import profiler
from audio_processor_tpu_torch.pipeline.chunker import Chunk, chunk_batch
from audio_processor_tpu_torch.utils.text import remove_special_characters

logger = logging.getLogger(__name__)

SEQ_MULTIPLE = 256   # encoder frames are padded to this (the reference's)
# so that every batch's L takes the kernel of its attention path.
assert all(SEQ_MULTIPLE % m == 0 for m in w2v.KERNEL_L_MULTIPLE.values())
PREP_AHEAD = 3       # host prep runs this many sub-batches ahead
PACE_DEPTH = 1       # device batches queued behind the running one


def pad_seq(feats: torch.Tensor, mask: torch.Tensor):
    """Pad the feature-frame axis to a multiple of 256, as the reference
    does for its flash kernel (the CUDA kernel needs only 64; keeping
    256 keeps shapes equal to the reference's). Padding is masked, so
    logits of valid frames do not change."""
    pad = (-feats.shape[1]) % SEQ_MULTIPLE
    if pad:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return feats, mask


class _SubBatch:
    """Slice view over a ChunkBatch. ``audio`` stays lazy so the fused
    path (which uploads raw agent/client rows) never builds the dense
    [N, 3, L] host tensor."""

    def __init__(self, batch, start: int, end: int):
        self.bucket_len = batch.bucket_len
        self.chunks = batch.chunks[start:end]
        self.lengths = batch.lengths[start:end]
        self._batch = batch
        self._span = (start, end)

    @property
    def audio(self):
        s, e = self._span
        return self._batch.audio[s:e]

    def __len__(self) -> int:
        return len(self.chunks)


class ASREngine:
    def __init__(self, config, device, model: Optional[torch.nn.Module]
                 = None, vocab=None, mesh=None):
        self.config = config
        self.mesh = mesh
        # The speech-to-text model (else the CTC model); refuses what it
        # does not run.
        self.s2t = s2t.check_pipeline_config(config)
        if mesh is None:
            replica_devices = [torch.device(device)]
        elif mesh.multi_process:
            replica_devices = [mesh.local_device]
        else:
            replica_devices = [torch.device(d) for d in
                               mesh.devices.reshape(mesh.devices.shape[0],
                                                    -1)[:, 0]]
        self.device = replica_devices[0]
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ASREngine asked for CUDA, but "
                               "torch.cuda.is_available() is False")
        self.dtype = (torch.bfloat16
                      if config.get("enable_mixed_precision", True)
                      else torch.float32)
        self.quantization = str(config.get("quantization", "none"))
        if self.quantization not in ("none", "", "int8"):
            raise ValueError(
                f"unknown quantization mode {self.quantization!r} "
                "(expected 'none' or 'int8')")
        if model is None:
            model, vocab = self._load_or_init()
        self.model = model.to(self.device).eval()
        if self.quantization == "int8":
            logger.info("int8 W8A8 inference enabled")
            self.model = (s2t.quantize_model if self.s2t
                          else w2v.quantize_model)(self.model)
        self.model_cfg = model.cfg
        if self.s2t:
            if self.model.rule != s2t.rule_from_config(config):
                raise ValueError(
                    f"the model's decode-length rule {self.model.rule} is "
                    f"not the config's {s2t.rule_from_config(config)}")
            self.model.cast_decoder(self.dtype)
            lang = config.get("s2t_tgt_lang_id", None)
            self.lang_id = (self.model_cfg.vocab_size - 1 if lang is None
                            else int(lang))
            # decoder.loop span attributes per device batch, by its text
            # mask, until the fetch counts its tokens.
            self._loop_attrs: Dict[int, dict] = {}
        # One model per 'data' device (the first is self.model), and the
        # fused-program calls each has run.
        self.replicas = [self.model] + [
            copy.deepcopy(self.model).to(d) for d in replica_devices[1:]]
        self.replica_devices = replica_devices
        self.replica_dispatches = [0] * len(self.replicas)
        if vocab is None:
            vocab = (PieceVocab.synthetic(self.model_cfg.vocab_size, 0,
                                          self.lang_id) if self.s2t
                     else CTCVocab.darija_default())
        self.vocab = vocab
        sr = int(config.get("target_sample_rate", 16000))
        self.bucket_samples = tuple(
            int(b * sr) for b in config.get(
                "length_buckets_sec", (5.0, 10.0, 15.0, 20.0, 25.0)))
        # A chunk longer than the largest bucket would be truncated by
        # the batcher; extend the bucket set instead. The message path's
        # VAD windows (capped at vad_max_segment_sec) flow through the
        # same buckets, so they get the same guard.
        chunk_samples = int(float(config.get("chunk_duration_sec", 25.0))
                            * sr)
        if config.get("enable_message_path", False):
            chunk_samples = max(chunk_samples, int(
                float(config.get("vad_max_segment_sec", 25.0)) * sr))
        if chunk_samples > max(self.bucket_samples):
            logger.warning(
                "longest chunk/VAD segment (%s samples) exceeds the "
                "largest length bucket; adding a %d-sample bucket",
                chunk_samples, chunk_samples)
            self.bucket_samples = tuple(
                sorted(set(self.bucket_samples) | {chunk_samples}))
        self.device_chunks = int(config.get("chunk_batch_size", 16)) \
            * len(self.replicas)
        self.device_batch = self.device_chunks * 3   # rows: 3 views each
        # int16 wire: half the host->device bytes, lossless for PCM16
        # sources. Disable for exact float parity on synthetic floats.
        self.int16_transfers = bool(config.get("int16_transfers", True))
        self.fuse_acoustic_features = bool(
            config.get("fuse_acoustic_features", True))
        self.emit_word_timestamps = bool(
            config.get("emit_word_timestamps", False))
        # Message-path decoding: 1 = greedy (reference parity); > 1 =
        # CTC prefix beam search over the log posteriors.
        self.beam_width = int(config.get("beam_width", 1))
        self.beam_word_bonus = float(config.get("beam_word_bonus", 0.0))
        self._frame_sec = HOP_LENGTH * STRIDE / sr  # 20 ms encoder frame
        self.attention_impl = w2v.resolve_attention_impl(
            config.get("attention_impl", "auto"), self.device)
        # (bucket_len, device chunks), and ("mono", bucket_len, rows,
        # beam) for the mono programs, already run: warmup() skips them.
        self._warmed: set = set()
        # Fused- and mono-program calls; each runs every encoder layer
        # once. mono_shapes counts the mono calls by (rows, bucket_len).
        self.dispatches = 0
        self.mono_dispatches = 0
        self.mono_shapes: Counter = Counter()
        # Completion events of the last device batches dispatched through
        # dispatch_chunks, oldest first (one list per batch: an event per
        # replica), across calls: what _pace waits on.
        self._queued: deque = deque()
        self._queued_lock = threading.Lock()
        # The stream dispatch_chunks enqueues on, per CUDA device.
        self._streams = {d: torch.cuda.Stream(d)
                         for d in dict.fromkeys(replica_devices)
                         if d.type == "cuda"}

    # ------------------------------------------------------------------
    def _load_or_init(self):
        model_path = self.config.get("transcription_model", "")
        if self.s2t:
            if model_path and Path(model_path).exists():
                raise ValueError(
                    f"asr_model_type {s2t.MODEL_TYPE!r} does not load "
                    f"checkpoints yet (transcription_model {model_path!r})")
            logger.warning("%s: randomly initialized weights at the "
                           "published widths (synthetic mode)",
                           s2t.MODEL_TYPE)
            return s2t.build_synthetic(
                s2t.S2TConfig(), self.device, seed=0,
                rule=s2t.rule_from_config(self.config)), None
        if model_path and Path(model_path).exists():
            logger.info("Loading checkpoint from %s", model_path)
            cfg, sd, vocab_dict = load_or_convert_w2v_bert(model_path)
            # The model's tensors are the loaded CPU ones (assign), so the
            # weights exist once until the engine moves them to its device.
            with torch.device("meta"):
                model = w2v.Wav2Vec2Bert(cfg)
            model.load_state_dict(sd, assign=True)
            vocab = (CTCVocab(vocab_dict) if vocab_dict
                     else CTCVocab.darija_default())
            return model, vocab
        logger.warning(
            "transcription_model path %r not found — using randomly "
            "initialized weights (synthetic mode)", model_path)
        vocab = CTCVocab.darija_default()
        cfg = w2v.W2VBertConfig(vocab_size=len(vocab))
        return w2v.build_synthetic(cfg, self.device, seed=0), vocab

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _fused(self, buf: torch.Tensor, lengths: torch.Tensor,
               bucket_len: int, replica: int = 0,
               caps: Optional[np.ndarray] = None, steps: int = 0):
        """The fused device program on replica ``replica``: buf [N, 2,
        bucket+2*PAD] (agent, client; int16 or f32) and lengths [N] ->
        (ids [3N, L'], mask [3N, L'], acoustic features [N, 2, 38]), all on
        the replica's device. Span ``asr_fused``: the launches of one
        device batch (``asr_fused.launches_per_batch``).

        The speech-to-text model decodes ``steps`` tokens, each row to
        ``</s>`` or its cap (``caps`` [3N] on the host; 0 for a padding
        row): ids [3N, steps] and the mask of each row's text tokens."""
        with profiler.span("asr_fused", bucket=bucket_len, replica=replica):
            x = buf.float()
            if buf.dtype == torch.int16:
                x = x / 32768.0
            N = x.shape[0]
            agent = x[:, 0, PAD:PAD + bucket_len]
            client = x[:, 1, PAD:PAD + bucket_len]
            mixed = (agent + client) * 0.5
            rows = torch.stack([mixed, agent, client],
                               dim=1).reshape(3 * N, bucket_len)
            feats, mask = log_mel_frontend(rows,
                                           lengths.repeat_interleave(3))
            feats, mask = pad_seq(feats, mask)
            if self.s2t:
                ids, mask, attrs = self.replicas[replica](
                    feats, mask, upload(caps, buf.device), steps,
                    self.lang_id, dtype=self.dtype,
                    attention_impl=self.attention_impl)
                if attrs is not None:
                    self._loop_attrs[id(mask)] = attrs
            else:
                logits = self.replicas[replica](
                    feats, mask, dtype=self.dtype,
                    attention_impl=self.attention_impl)
                ids = w2v.greedy_ctc_ids(logits, mask,
                                         self.model_cfg.pad_token_id)
            af = extract_features_batch(x.reshape(2 * N, -1),
                                        lengths.repeat_interleave(2))
        self.dispatches += 1
        self.replica_dispatches[replica] += 1
        return ids, mask, af.reshape(N, 2, -1)

    def _run_fused(self, buf: np.ndarray, lengths: np.ndarray,
                   bucket_len: int, n_real: Optional[int] = None):
        """Enqueue the fused program on one padded device batch, one
        equal slice per replica (the whole batch when there is one):
        a list of the replicas' outputs, concatenated on the host at
        fetch. The first ``n_real`` chunks are real (default: all); the
        speech-to-text model decodes no token for the others."""
        n = buf.shape[0] // len(self.replicas)
        kw = [{} for _ in self.replicas]
        if self.s2t:
            real = buf.shape[0] if n_real is None else n_real
            caps = np.repeat(np.asarray(
                self.model.caps(lengths[:real]) + [0] * (len(lengths) - real),
                np.int64), 3)
            steps = int(caps.max())
            kw = [{"caps": caps[3 * i * n:3 * (i + 1) * n], "steps": steps}
                  for i in range(len(self.replicas))]
        return [self._fused(upload(buf[i * n:(i + 1) * n], dev),
                            upload(lengths[i * n:(i + 1) * n], dev),
                            bucket_len, replica=i, **kw[i])
                for i, dev in enumerate(self.replica_devices)]

    @torch.inference_mode()
    def _mono(self, rows: torch.Tensor, lengths: torch.Tensor,
              beam: bool):
        """The mono-rows program: rows [N, L] (int16 or f32) and
        lengths [N] -> (greedy ids [N, L'], mask [N, L']), or with
        ``beam`` (log posteriors [N, L', vocab], mask), on the device.
        One body (dequantize, fbank, pad, encoder) serves both heads,
        so the greedy and beam numerics cannot drift apart."""
        if self.s2t:
            raise ValueError(f"asr_model_type {s2t.MODEL_TYPE!r} has no "
                             "mono-rows program")
        x = rows.float()
        if rows.dtype == torch.int16:   # wire format (half the upload)
            x = x * (1.0 / 32768.0)
        feats, mask = log_mel_frontend(x, lengths)
        feats, mask = pad_seq(feats, mask)
        logits = self.model(feats, mask, dtype=self.dtype,
                            attention_impl=self.attention_impl)
        self.mono_dispatches += 1
        self.mono_shapes[tuple(rows.shape)] += 1
        if beam:
            return torch.log_softmax(logits, dim=-1), mask
        return (w2v.greedy_ctc_ids(logits, mask, self.model_cfg.pad_token_id),
                mask)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return upload(arr, self.device)

    def warmup(self, all_buckets: bool = False,
               tail_sizes: Optional[Sequence[int]] = None,
               message_rows: Optional[bool] = None) -> int:
        """Run the chunk programs once per (bucket, tail) shape before
        the timeout-bounded batch loop, so first-use costs (kernel
        build, cuBLAS heuristics, allocator growth) are not mistaken for
        a hung device. Covers the top bucket (``all_buckets``: every
        bucket) at the full and tail batch sizes; returns the number of
        shapes run. Shapes already run in this process are skipped.

        ``message_rows`` (default: the config's enable_message_path)
        also runs the mono-rows program at every bucket x {B/4, B/2, B}
        rows (B = 3 x chunk_batch_size): VAD segments land in every
        bucket."""
        buckets = (list(self.bucket_samples) if all_buckets
                   else [max(self.bucket_samples)])
        if tail_sizes is None:
            tail_sizes = {self.device_chunks, self._tail_size(1),
                          self._tail_size(max(1, self.device_chunks // 2))}
        n_shapes = 0
        for bucket in buckets:
            zeros = np.zeros(bucket, np.float32)
            for n in sorted(set(tail_sizes)):
                key = (bucket, self._tail_size(n)
                       if self.fuse_acoustic_features
                       else self.device_chunks)
                if key in self._warmed:
                    continue
                warm = [Chunk("warmup.wav", i, 0.0, 0.0,
                              agent=zeros, client=zeros)
                        for i in range(n)]
                self.transcribe_chunks(warm)
                n_shapes += 1
        if message_rows is None:
            message_rows = bool(
                self.config.get("enable_message_path", False))
        if message_rows:
            B = self.device_batch
            row_sizes = sorted({self._row_tail_size(1),
                                self._row_tail_size(B // 2), B})
            for bucket in self.bucket_samples:
                for rows_n in row_sizes:
                    key = ("mono", bucket, rows_n, self.beam_width > 1)
                    if key in self._warmed:
                        continue
                    self._run_rows(
                        np.zeros((rows_n, bucket), np.float32),
                        np.full((rows_n,), bucket, np.int32), bucket)
                    self._warmed.add(key)
                    n_shapes += 1
        return n_shapes

    def _tail_size(self, n: int) -> int:
        """Static device chunk count for a sub-batch of n chunks: the
        full size mid-bucket, or the smallest power-of-two fraction
        (>= 1/4, still divisible by the replica count) that fits a final
        partial sub-batch."""
        n_dev = self.device_chunks
        for _ in range(2):
            half = n_dev // 2
            if n <= half and half % len(self.replicas) == 0 and half >= 1:
                n_dev = half
            else:
                break
        return n_dev

    def _prepare_fused_buffer(self, batch, n_dev: Optional[int] = None
                              ) -> tuple:
        """Host prep: [n_dev, 2, bucket+2*PAD] reflect-padded agent/
        client buffer (int16 when enabled) and [n_dev] lengths, padded
        to the static device chunk count. Uses the GIL-free C++ prep
        (io.native.prepare_fused_int16) when it is built."""
        n = len(batch)
        if n_dev is None:
            n_dev = self.device_chunks
        L = batch.bucket_len
        lengths = batch.lengths.astype(np.int32)
        if n < n_dev:
            # Padding rows keep length L so the masked statistics stay
            # well defined on zero audio.
            lengths = np.concatenate(
                [lengths, np.full((n_dev - n,), L, np.int32)])

        if self.int16_transfers and native.has_prepare_fused():
            zero = np.zeros(0, np.float32)
            agents = [c.agent for c in batch.chunks] + [zero] * (n_dev - n)
            clients = [c.client for c in batch.chunks] + \
                [zero] * (n_dev - n)
            data_lens = np.array([c.num_samples for c in batch.chunks]
                                 + [0] * (n_dev - n), np.int64)
            buf = native.prepare_fused_int16(agents, clients, data_lens, L,
                                             PAD)
            if buf is not None:
                return buf, lengths

        waves = []
        for c in batch.chunks:
            waves.append(c.agent)
            waves.append(c.client)
        waves += [np.zeros(0, np.float32)] * (2 * (n_dev - n))
        buf2, _ = prepare_reflect_padded(waves, L)   # [2n_dev, L+2*PAD]
        buf = buf2.reshape(n_dev, 2, L + 2 * PAD)
        if self.int16_transfers:
            buf = np.clip(np.round(buf * 32768.0),
                          -32768, 32767).astype(np.int16)
        return buf, lengths

    # ------------------------------------------------------------------
    def transcribe_chunks(self, chunks: Sequence[Chunk]) -> List[Dict]:
        """Adds transcription_chunk / agent_transcription /
        client_transcription and the acoustic features to every chunk
        (the reference's result contract)."""
        return self.dispatch_chunks(chunks)()

    def dispatch_chunks(self, chunks: Sequence[Chunk]):
        """Prep + enqueue every sub-batch on the device, then return a
        closure that fetches, decodes and assembles the rows. Host prep
        runs a few sub-batches ahead on a small thread pool (the C++
        prep releases the GIL), bounded so host memory stays O(1) in
        the sweep size."""
        if not chunks:
            return lambda: []
        results: Dict[int, Dict] = {}
        batches = chunk_batch(
            chunks, self.bucket_samples,
            sort_by_length=bool(self.config.get("enable_length_bucketing",
                                                True)))
        subs = []
        for batch in batches:
            for i in range(0, len(batch), self.device_chunks):
                n = min(self.device_chunks, len(batch) - i)
                subs.append(_SubBatch(batch, i, i + n))

        # Prep runs on the pool's threads: its spans name this one's.
        parent = profiler.current()

        def _prep(idx: int):
            s = subs[idx]
            n_dev = self._tail_size(len(s))
            with profiler.span("asr_engine.prep", parent=parent,
                               bucket=s.bucket_len, rows=len(s),
                               rows_dispatched=n_dev):
                return self._prepare_fused_buffer(s, n_dev)

        prep_pool = None
        prep_futs: Dict[int, object] = {}
        if self.fuse_acoustic_features and len(subs) > 1:
            prep_pool = ThreadPoolExecutor(max_workers=2)
            for k in range(min(PREP_AHEAD, len(subs))):
                prep_futs[k] = prep_pool.submit(_prep, k)

        pending = []  # (chunk_list, device_outputs, error)
        done = []     # per pending entry: (bucket, its device events)
        streams = self._on_streams()
        try:
            for k, sub in enumerate(subs):
                try:
                    if not self.fuse_acoustic_features:
                        rows, lengths = self._prepare_rows(sub)
                        self._pace()
                        out = self._mono(self._upload(rows),
                                         self._upload(lengths), beam=False)
                        self._warmed.add((sub.bucket_len,
                                          self.device_chunks))
                        pending.append((sub.chunks, out, None))
                        done.append((sub.bucket_len, self._queue_events()))
                        continue
                    if prep_pool is not None and k + PREP_AHEAD < len(subs):
                        prep_futs[k + PREP_AHEAD] = prep_pool.submit(
                            _prep, k + PREP_AHEAD)
                    fut = prep_futs.pop(k, None)
                    buf, lengths = (fut.result() if fut is not None
                                    else _prep(k))
                    with profiler.span(
                            "asr_engine.dispatch", bucket=sub.bucket_len,
                            rows=len(sub), rows_dispatched=buf.shape[0],
                            h2d_bytes=buf.nbytes + lengths.nbytes):
                        self._pace()
                        out = self._run_fused(buf, lengths, sub.bucket_len,
                                              n_real=len(sub))
                    self._warmed.add((sub.bucket_len, buf.shape[0]))
                    pending.append((sub.chunks, out, None))
                    done.append((sub.bucket_len, self._queue_events()))
                except Exception as e:  # a failed batch fails its files
                    logger.exception("ASR dispatch failed (bucket %d): %s",
                                     sub.bucket_len, e)
                    pending.append((sub.chunks, None, str(e)))
                    done.append((sub.bucket_len, None))
        finally:
            streams.close()
            if prep_pool is not None:
                prep_pool.shutdown(wait=False, cancel_futures=True)

        return lambda: self._fetch_pending(chunks, pending, results, done)

    def _on_streams(self) -> contextlib.ExitStack:
        """Make the engine's stream current on each of its CUDA devices."""
        stack = contextlib.ExitStack()
        for stream in self._streams.values():
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    def _done_events(self) -> Optional[list]:
        """On a CUDA engine: one event per replica device behind the work
        enqueued so far (blocking: a wait yields the CPU). The fetch syncs
        on them apart from the copies (``asr_engine.fetch_wait``), and
        :meth:`_pace` waits on them. None on the CPU."""
        if self.device.type != "cuda":
            return None
        events = []
        for dev in self.replica_devices:
            e = torch.cuda.Event(blocking=True)
            e.record(torch.cuda.current_stream(dev))
            events.append(e)
        return events

    def _queue_events(self) -> Optional[list]:
        """:meth:`_done_events` of the device batch just dispatched, also
        queued for :meth:`_pace`."""
        events = self._done_events()
        if events is not None:
            with self._queued_lock:
                self._queued.append(events)
        return events

    def _pace(self) -> None:
        """Before a device batch is enqueued: wait (span
        ``asr_engine.pace``) until the card has finished the batch
        ``PACE_DEPTH + 1`` before it, so at most ``PACE_DEPTH`` batches
        are queued behind the one running. No events, no wait."""
        while True:
            with self._queued_lock:
                if len(self._queued) <= PACE_DEPTH:
                    return
                events = self._queued.popleft()
            with profiler.span("asr_engine.pace"):
                for e in events:
                    e.synchronize()

    def _fetch_pending(self, chunks, pending, results,
                       done=None) -> List[Dict]:
        """Fetch + decode in dispatch order, then assemble one row per
        chunk (a failed sub-batch yields rows with ``error`` set).
        ``done`` holds each entry's (bucket, device events)."""
        for k, (sub_chunks, out, err) in enumerate(pending):
            n = len(sub_chunks)
            if err is None:
                bucket, events = done[k] if done else (None, None)
                with profiler.span("asr_engine.fetch_wait", bucket=bucket,
                                   rows=n):
                    for e in events or ():
                        e.synchronize()
                try:
                    parts = out if isinstance(out, list) else [out]
                    ids, mask, *af = (
                        np.concatenate([p[i].cpu().numpy() for p in parts])
                        for i in range(len(parts[0])))
                    af = af[0][:n] if af else None   # unfused: none
                    if self.s2t:
                        self._count_tokens(parts, ids)
                except Exception as e:
                    logger.exception("ASR fetch failed: %s", e)
                    err = str(e)
            if err is not None:
                for c in sub_chunks:
                    results[id(c)] = {
                        "transcription_chunk": "",
                        "agent_transcription": "",
                        "client_transcription": "",
                        "error": err,
                    }
                continue
            with profiler.span("asr_engine.ctc_decode", rows=3 * n):
                ids, mask = ids[:3 * n], mask[:3 * n]
                texts = batch_decode(ids, self.vocab, mask)
                for j, c in enumerate(sub_chunks):
                    r = {
                        "transcription_chunk":
                            remove_special_characters(texts[3 * j]),
                        "agent_transcription":
                            remove_special_characters(texts[3 * j + 1]),
                        "client_transcription":
                            remove_special_characters(texts[3 * j + 2]),
                        "error": "",
                    }
                    if af is not None:
                        r["agent_acoustic_features"] = af[j, 0]
                        r["client_acoustic_features"] = af[j, 1]
                    if self.emit_word_timestamps:
                        for view, name in ((0, "mixed_words"),
                                           (1, "agent_words"),
                                           (2, "client_words")):
                            row = ids[3 * j + view]
                            valid = row[mask[3 * j + view].astype(bool)]
                            r[name] = decode_words(
                                valid, self.vocab, self._frame_sec,
                                offset_sec=c.start_time)
                    results[id(c)] = r

        out_rows = []
        for c in chunks:
            row = {
                "file_name": c.file_name,
                "chunk_idx": c.chunk_idx,
                "start_time": c.start_time,
                "end_time": c.end_time,
                "agent_waveform": c.agent,
                "client_waveform": c.client,
            }
            row.update(results.get(id(c), {
                "transcription_chunk": "", "agent_transcription": "",
                "client_transcription": "", "error": "missing_result",
            }))
            out_rows.append(row)
        return out_rows

    def _count_tokens(self, parts, ids) -> None:
        """Fill each fetched device batch's ``decoder.loop`` span with the
        tokens its rows emitted (``</s>`` included; never the pad id)."""
        row = 0
        for p in parts:
            n = p[1].shape[0]
            attrs = self._loop_attrs.pop(id(p[1]), None)
            if attrs is not None:
                attrs["tokens"] = int(
                    (ids[row:row + n] != self.model_cfg.pad_token_id).sum())
            row += n

    def _prepare_rows(self, batch) -> tuple:
        """Unfused path: [3N, L] float32 view rows (mixed, agent, client
        per chunk) and lengths, padded to the static device batch."""
        n = len(batch)
        rows = batch.audio.reshape(n * 3, batch.bucket_len)
        lengths = np.repeat(batch.lengths, 3).astype(np.int32)
        B = self.device_batch
        if rows.shape[0] < B:
            pad = B - rows.shape[0]
            rows = np.concatenate(
                [rows, np.zeros((pad, batch.bucket_len), np.float32)])
            lengths = np.concatenate(
                [lengths, np.full((pad,), batch.bucket_len, np.int32)])
        return rows, lengths

    # ------------------------------------------------------------------
    def _row_tail_size(self, n: int) -> int:
        """Static row count for an n-row mono dispatch: the full device
        batch mid-stream, or the smallest power-of-two fraction (>= 1/4)
        that covers a final partial batch (a handful of VAD segments
        padded to 48 rows would burn ~10x their device time)."""
        B = self.device_batch
        for _ in range(2):
            half = B // 2
            if n <= half and half >= 1:
                B = half
            else:
                break
        return B

    def _dispatch_rows(self, rows: np.ndarray, lengths: np.ndarray,
                       bucket_len: int):
        """Upload [N, bucket_len] audio rows (int16 when every sample is
        int16-exact), enqueue every sub-batch of the mono program, and
        return a fetch closure, so callers holding several bucket
        batches enqueue them all before fetching any. The closure
        decodes greedily, or with CTC prefix beam search when
        ``beam_width > 1``."""
        beam = self.beam_width > 1
        B = self.device_batch
        n = rows.shape[0]
        if self.int16_transfers:
            rows = maybe_int16_wire(rows)
        pending = []
        for i in range(0, n, B):
            sl_rows = rows[i:i + B]
            sl_len = lengths[i:i + B].astype(np.int32)
            valid = sl_rows.shape[0]
            n_dev = self._row_tail_size(valid)
            if valid < n_dev:  # pad to the static tail batch
                pad = n_dev - valid
                sl_rows = np.concatenate(
                    [sl_rows, np.zeros((pad, bucket_len), rows.dtype)])
                sl_len = np.concatenate(
                    [sl_len, np.full((pad,), bucket_len, np.int32)])
            pending.append((valid, self._mono(
                self._upload(sl_rows), self._upload(sl_len), beam)))

        def fetch() -> List[str]:
            out_texts: List[str] = []
            for valid, (out, mask) in pending:
                out = out[:valid].cpu().numpy()
                mask = mask[:valid].cpu().numpy()
                if not beam:
                    out_texts.extend(batch_decode(out, self.vocab, mask))
                    continue
                for b in range(valid):
                    hyps = ctc_beam_search(
                        out[b], self.vocab, beam_width=self.beam_width,
                        word_bonus=self.beam_word_bonus,
                        mask=mask[b].astype(bool))
                    out_texts.append(hyps[0][0] if hyps else "")
            return out_texts

        return fetch

    def _run_rows(self, rows: np.ndarray, lengths: np.ndarray,
                  bucket_len: int) -> List[str]:
        """Transcribe [N, L] audio rows: dispatch + immediate fetch."""
        return self._dispatch_rows(rows, lengths, bucket_len)()

    def transcribe_mono_segments(self, waves: List[np.ndarray]) -> List[str]:
        """Transcribe variable-length mono segments (the VAD message
        path). Every bucket batch is enqueued before any is fetched."""
        if not waves:
            return []
        mono = [np.asarray(w, np.float32).reshape(-1) for w in waves]
        chunks = [
            Chunk(file_name="", chunk_idx=i, start_time=0.0, end_time=0.0,
                  mixed=w, agent=w, client=w)
            for i, w in enumerate(mono)
        ]
        texts: Dict[int, str] = {}
        dispatched = []
        for batch in chunk_batch(chunks, self.bucket_samples):
            # Mono rows built directly (ChunkBatch.audio would build all
            # three views only for view 0 to be kept).
            rows = np.zeros((len(batch), batch.bucket_len), np.float32)
            for j, c in enumerate(batch.chunks):
                t = int(batch.lengths[j])
                rows[j, :t] = c.mixed[:t]
            dispatched.append((batch, self._dispatch_rows(
                rows, batch.lengths, batch.bucket_len)))
        for batch, fetch in dispatched:
            out = fetch()
            for j, c in enumerate(batch.chunks):
                texts[c.chunk_idx] = out[j]
        return [texts.get(i, "") for i in range(len(waves))]
