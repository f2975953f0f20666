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
N's host work; CUDA launches are asynchronous like JAX dispatch).

Weights: an HF checkpoint directory when ``transcription_model`` points
at one (models/checkpoint.py: converted once, then restored from its
``torch_converted/`` cache), else seeded random weights with the default
Darija vocabulary (synthetic mode, logged). ``quantization: int8`` runs
the encoder's dense layers as W8A8 (models/quant.py), on a loaded or a
given model alike.

Not ported yet (ROADMAP.md, Queue 1): the message-path mono programs
(``_mono_fn``/``_dispatch_rows``, and with them the unfused path) and
device meshes.
"""

from __future__ import annotations

import logging
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
from audio_processor_tpu_torch.models import wav2vec2bert as w2v
from audio_processor_tpu_torch.models.checkpoint import (
    load_or_convert_w2v_bert,
)
from audio_processor_tpu_torch.models.tokenizer import (
    CTCVocab, batch_decode, decode_words,
)
from audio_processor_tpu_torch.pipeline.chunker import Chunk, chunk_batch
from audio_processor_tpu_torch.utils.text import remove_special_characters

logger = logging.getLogger(__name__)

SEQ_MULTIPLE = 256   # encoder frames are padded to this (the reference's)
# so that every batch's L takes the kernel of its attention path.
assert all(SEQ_MULTIPLE % m == 0 for m in w2v.KERNEL_L_MULTIPLE.values())
PREP_AHEAD = 3       # host prep runs this many sub-batches ahead


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
    """Slice view over a ChunkBatch (chunks and lengths only: the fused
    path uploads raw agent/client rows)."""

    def __init__(self, batch, start: int, end: int):
        self.bucket_len = batch.bucket_len
        self.chunks = batch.chunks[start:end]
        self.lengths = batch.lengths[start:end]

    def __len__(self) -> int:
        return len(self.chunks)


class ASREngine:
    def __init__(self, config, device, model: Optional[w2v.Wav2Vec2Bert]
                 = None, vocab: Optional[CTCVocab] = None):
        self.config = config
        self.device = torch.device(device)
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
        if not config.get("fuse_acoustic_features", True):
            raise NotImplementedError(
                "fuse_acoustic_features: false needs the mono-rows "
                "program, which is not ported yet (ROADMAP.md, Queue 1: "
                "message path)")
        if model is None:
            model, vocab = self._load_or_init()
        self.model = model.to(self.device).eval()
        if self.quantization == "int8":
            logger.info("int8 W8A8 inference enabled")
            self.model = w2v.quantize_model(self.model)
        self.model_cfg = model.cfg
        self.vocab = vocab or CTCVocab.darija_default()
        sr = int(config.get("target_sample_rate", 16000))
        self.bucket_samples = tuple(
            int(b * sr) for b in config.get(
                "length_buckets_sec", (5.0, 10.0, 15.0, 20.0, 25.0)))
        # A chunk longer than the largest bucket would be truncated by
        # the batcher; extend the bucket set instead.
        chunk_samples = int(float(config.get("chunk_duration_sec", 25.0))
                            * sr)
        if chunk_samples > max(self.bucket_samples):
            logger.warning(
                "longest chunk (%s samples) exceeds the largest length "
                "bucket; adding a %d-sample bucket",
                chunk_samples, chunk_samples)
            self.bucket_samples = tuple(
                sorted(set(self.bucket_samples) | {chunk_samples}))
        self.device_chunks = int(config.get("chunk_batch_size", 16))
        # int16 wire: half the host->device bytes, lossless for PCM16
        # sources. Disable for exact float parity on synthetic floats.
        self.int16_transfers = bool(config.get("int16_transfers", True))
        self.emit_word_timestamps = bool(
            config.get("emit_word_timestamps", False))
        self._frame_sec = HOP_LENGTH * STRIDE / sr  # 20 ms encoder frame
        self.attention_impl = w2v.resolve_attention_impl(
            config.get("attention_impl", "auto"), self.device)
        # (bucket_len, device chunks) already dispatched: warmup()
        # skips them.
        self._warmed: set = set()
        # Fused-program calls; each runs every encoder layer once.
        self.dispatches = 0

    # ------------------------------------------------------------------
    def _load_or_init(self):
        model_path = self.config.get("transcription_model", "")
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
               bucket_len: int):
        """The fused device program: buf [N, 2, bucket+2*PAD] (agent,
        client; int16 or f32) and lengths [N] -> (ids [3N, L'], mask
        [3N, L'], acoustic features [N, 2, 38]), all on the device."""
        x = buf.float()
        if buf.dtype == torch.int16:
            x = x / 32768.0
        N = x.shape[0]
        agent = x[:, 0, PAD:PAD + bucket_len]
        client = x[:, 1, PAD:PAD + bucket_len]
        mixed = (agent + client) * 0.5
        rows = torch.stack([mixed, agent, client],
                           dim=1).reshape(3 * N, bucket_len)
        feats, mask = log_mel_frontend(rows, lengths.repeat_interleave(3))
        feats, mask = pad_seq(feats, mask)
        logits = self.model(feats, mask, dtype=self.dtype,
                            attention_impl=self.attention_impl)
        ids = w2v.greedy_ctc_ids(logits, mask, self.model_cfg.pad_token_id)
        af = extract_features_batch(x.reshape(2 * N, -1),
                                    lengths.repeat_interleave(2))
        self.dispatches += 1
        return ids, mask, af.reshape(N, 2, -1)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            # Pinned staging makes the copy asynchronous; the caching
            # host allocator keeps the block until the copy is done.
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def warmup(self, all_buckets: bool = False,
               tail_sizes: Optional[Sequence[int]] = None) -> int:
        """Run the chunk programs once per (bucket, tail) shape before
        the timeout-bounded batch loop, so first-use costs (kernel
        build, cuBLAS heuristics, allocator growth) are not mistaken for
        a hung device. Covers the top bucket (``all_buckets``: every
        bucket) at the full and tail batch sizes; returns the number of
        shapes run. Shapes already run in this process are skipped."""
        buckets = (list(self.bucket_samples) if all_buckets
                   else [max(self.bucket_samples)])
        if tail_sizes is None:
            tail_sizes = {self.device_chunks, self._tail_size(1),
                          self._tail_size(max(1, self.device_chunks // 2))}
        n_shapes = 0
        for bucket in buckets:
            zeros = np.zeros(bucket, np.float32)
            for n in sorted(set(tail_sizes)):
                if (bucket, self._tail_size(n)) in self._warmed:
                    continue
                warm = [Chunk("warmup.wav", i, 0.0, 0.0,
                              agent=zeros, client=zeros)
                        for i in range(n)]
                self.transcribe_chunks(warm)
                n_shapes += 1
        return n_shapes

    def _tail_size(self, n: int) -> int:
        """Static device chunk count for a sub-batch of n chunks: the
        full size mid-bucket, or the smallest power-of-two fraction
        (>= 1/4) that fits a final partial sub-batch."""
        n_dev = self.device_chunks
        for _ in range(2):
            half = n_dev // 2
            if n <= half and half >= 1:
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

        def _prep(idx: int):
            s = subs[idx]
            return self._prepare_fused_buffer(s, self._tail_size(len(s)))

        prep_pool = None
        prep_futs: Dict[int, object] = {}
        if len(subs) > 1:
            prep_pool = ThreadPoolExecutor(max_workers=2)
            for k in range(min(PREP_AHEAD, len(subs))):
                prep_futs[k] = prep_pool.submit(_prep, k)

        pending = []  # (chunk_list, device_outputs, error)
        try:
            for k, sub in enumerate(subs):
                try:
                    if prep_pool is not None and k + PREP_AHEAD < len(subs):
                        prep_futs[k + PREP_AHEAD] = prep_pool.submit(
                            _prep, k + PREP_AHEAD)
                    fut = prep_futs.pop(k, None)
                    buf, lengths = (fut.result() if fut is not None
                                    else _prep(k))
                    out = self._fused(self._upload(buf),
                                      self._upload(lengths), sub.bucket_len)
                    self._warmed.add((sub.bucket_len, buf.shape[0]))
                    pending.append((sub.chunks, out, None))
                except Exception as e:  # a failed batch fails its files
                    logger.exception("ASR dispatch failed (bucket %d): %s",
                                     sub.bucket_len, e)
                    pending.append((sub.chunks, None, str(e)))
        finally:
            if prep_pool is not None:
                prep_pool.shutdown(wait=False, cancel_futures=True)

        return lambda: self._fetch_pending(chunks, pending, results)

    def _fetch_pending(self, chunks, pending, results) -> List[Dict]:
        """Fetch + decode in dispatch order, then assemble one row per
        chunk (a failed sub-batch yields rows with ``error`` set)."""
        for sub_chunks, out, err in pending:
            n = len(sub_chunks)
            if err is None:
                try:
                    ids, mask, af = (t.cpu().numpy() for t in out)
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
            ids, mask, af = ids[:3 * n], mask[:3 * n], af[:n]
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
                    "agent_acoustic_features": af[j, 0],
                    "client_acoustic_features": af[j, 1],
                }
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
