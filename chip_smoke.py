"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--only s2t|ln|topics|mla|kimi]

Phases, each of which fails the run (non-zero exit) on any error:

1. the card: name and power limit (nvidia-smi); no CUDA, no run;
2. build: the port's CUDA kernels from ``audio_processor_tpu_torch/csrc``
   (nvcc, sm_90a, one process per source, all at once; each kernel's
   ``-Xptxas -v`` lines printed) and, beside them, the port's native host
   I/O library (g++ over ``native/*.cpp`` into
   ``audio_processor_tpu_torch/io/_native/``); then ``cuobjdump -sass``
   must show warpgroup MMAs (HGMMA) in every bf16 tensor-core kernel and
   in every one of the nine instances of the ablation kernel;
3. kernel vs plain: the flash-rel attention kernel against its plain
   PyTorch version on the card, fp32 and bf16 with ragged kv masks at
   B=2 (L from 64 to 1280, 320 among them), and bf16 at every (B, L) the
   batch path and the message path give the kernel (B in {12, 24, 48} x
   L in {256, 512, 768, 1024, 1280}, H=16) with a valid length per batch
   row; both times at B=48, H=16, L=1280 on the inputs just checked;
3b. the flash kernel against its plain version: fp32 and bf16 at B=2,
   L in {64, 256, 320, 512, 1280}, with the bias built as the model
   builds it (ragged kv mask, one batch row wholly masked), and without a
   bias (L in {64, 320, 1280}, and at B=48, L=1280 bf16); bf16 at every
   (B, L) of the batch path under ``flash``; both times at B=48, H=16,
   L=1280 bf16 with the bias, and beside them the library call of the
   same function (``scaled_dot_product_attention`` with the bias as its
   mask), which the port never calls;
3c. every flash-rel ablation kernel against its plain twin at H=16,
   L=1280, B=2 and B=48 (the wrong-by-design modes: the same NaN/inf
   pattern, equal where finite); both times of each at B=48, and beside
   them the library call of the same function
   (``scaled_dot_product_attention``: bare without a mask, full and
   kb640 with the additive mask of s_rel and kv_mask, norel with the kv
   mask's term alone), which the port never calls;
3d. the encoder's CUDA graphs: at the full w2v-bert-2.0 width (random
   weights from the seed), bf16, under ``flash_rel``, under ``flash`` and
   with ``quantization: int8``, at every (rows, frames) the batch and
   message paths dispatch (MESSAGE_SHAPES), with ragged masks:
   ``Wav2Vec2Bert.forward`` captures on its first call and replays on
   the next two, whose logits must equal the eager body's bit for bit
   (the first replay's still equal after the second), and the kernel's
   launch counter must advance by 24 on every call and the fused
   LayerNorm's by 144 (6 per layer), which each ``encoder.graph`` span's
   ``ln_launches`` also reads; prints, at 48 x 1280
   under flash_rel, the host ms a call takes to return and the card ms
   per call, eager and replayed;
3e. the fused add-and-LayerNorm kernel (``csrc/add_layer_norm.cu``)
   against its plain version: at [61440, 1024] bf16 (48 x 1280 rows) in
   every form the conformer runs (no branch; a branch at alpha 0.5 with r
   written and not; alpha 1 with the mask; SiLU, on rows and on the
   depthwise convolution's [B, C, L] output read as it lies, which must
   give the rows' y bit for bit), at 24 x 97 and 24 x 104 rows and at
   widths 4096 and 72: r bit for bit, y within one bf16 step (of 2^-6
   below 2^-6, where the fp32 statistics' own rounding is larger), the mask
   and SiLU outputs equal to those ops on the kernel's own y; then each
   form's graph-timed ms at [61440, 1024] beside its byte bound, the plain
   version's ms and the library's (``F.layer_norm`` on bf16 rows, after
   ``torch.add`` where there is a branch) (``--only ln`` runs phases 1,
   2, 3e and 3d alone);
4. small reference: a tiny model through the port's ASR engine on the
   card (kernel path) and on the CPU (plain path), same weights and
   audio: masks equal, ids equal off near-ties, features close;
4b. the same under ``attention_impl: flash`` on both sides;
4c. the message path's small reference, under ``flash_rel`` and under
   ``flash``: PyanNet from a seeded pyannote-layout state dict
   (num_outputs=3), windowed probabilities card vs CPU within VAD_TOL;
   the energy detector's probabilities and mask card vs CPU; the tiny
   engine's mono-rows program, ids equal off near-ties and masks equal;
   ``beam_width: 4``, the card's texts equal ``ctc_beam_search`` of the
   card's own log posteriors, which match the CPU's within 1e-4;
   ``fuse_acoustic_features: false``, ids card vs CPU off near-ties; and
   once (flash_rel) under ``enable_profiling: true`` through
   ``obs.profiler.maybe_trace``: the trace names the flash-rel kernel;
4d. serving's small reference: one tiny fp32 engine's weights in two
   ``serving.InferenceService``s, one on the card and one on the CPU; the
   same 6 WAV bodies (2 to 9 s, one at 8 kHz) to both at once: chunk
   counts, times and order equal, and each chunk view's transcript equal
   where the CPU logits have no near tie (else both among the texts the
   near-tie frames' two top tokens give);
4e. fine-tuning's small reference: a tiny model (hidden 128, 2 heads of
   64, 2 layers, conv 7) with the same weights on the card and on the
   CPU, fp32 (TF32 off), no SpecAugment, 4 rows of 2 s with ragged
   masks and one row whose labels cannot fit its frames: 3 AdamW steps
   of ``training.train_step`` on each, losses within 1e-5, step-0
   gradients (all finite) within 1e-4 of each leaf's max, params and
   Adam moments after 3 steps within the CPU test's tolerances; one bf16
   step on the card, its loss and each row's within 2e-2 of fp32's; and
   ``flash_rel_attention`` refusing an operand that requires grad;
5. main path: 8 synthetic stereo calls of 100 s (3 at 8 kHz) through
   ``audio_processor_tpu_torch.pipeline.engine.DataProcessor`` at the
   full w2v-bert-2.0 width (random weights from the seed), bf16, CSV
   output; every file must succeed, every chunk must have its row, and
   the kernel must have run once per encoder layer per dispatched batch
   and the fused LayerNorm six times (144 per batch), both counted from 0
   just before the run; the same 144 per batch hold in phases 7, 8 and 9;
5b. the batch path under ``attention_impl: flash``: 4 calls of 100 s
   (1 at 8 kHz), the same checks with the flash kernel, and no
   flash_rel launch;
6. the ablation path: ``tools/profile_kernel_parts_torch.py`` over all
   its variants at B=48, H=16, L=1280; each ablation kernel launched;
7. the production configuration at full width: the script writes three
   HF-format checkpoint directories from its seed with its own
   safetensors writer (an ASR ``Wav2Vec2BertForCTC`` at w2v-bert-2.0
   width with the default Darija vocabulary, ~2.3 GB in fp32, and two
   BERT-base classifiers with the reference's client and agent labels
   and a synthetic ``vocab.txt``), then runs ``DataProcessor`` over 4
   stereo calls of 100 s (1 at 8 kHz) with ``transcription_model`` and
   both ``*_text_model_path``s set, CSV output. It fails unless the
   engine's weights equal the written ones bit for bit, a second load
   restores them from ``torch_converted/`` bit for bit, text sentiment
   is available, every chunk row has a text prediction exactly where its
   transcript has >= 5 stripped characters with probabilities summing to
   1 (1e-5), and the flash_rel kernel ran 24 times per batch. Prints the
   load times, the text classifier's ms per dispatch at each (B, bucket)
   the run hit and at B=16 for every bucket, and the phase's RTFx;
7b. the text analyzer on the card against the CPU, on a small BERT
   directory and the BERT-base one, 16 texts: probabilities within 1e-4,
   predictions equal off near-ties, and the tokenizer's ids the same on
   both;
7c. int8: a tiny engine with ``quantization: int8`` on the card and on
   the CPU (ids equal off near-ties), then 2 calls through
   ``DataProcessor`` at full width with ``quantization: int8`` and text
   on (every file succeeds, 24 flash_rel launches per batch), and the
   wall of one 48 x 1280 batch, int8 beside bf16;
8. the message path at full width: w2v-bert-2.0 width (random weights
   from the seed, bf16), ``enable_message_path: true`` with a SQLite
   ``DatabaseManager`` and ``vad_model_id`` naming a seeded PyanNet state
   dict the script writes (pyannote key layout, num_outputs=3), over 4
   stereo calls of 100 s (1 at 8 kHz). It fails unless every file
   succeeds with no error, the segmenter runs PyanNet (no energy
   fallback), no channel's VAD failed, every call has message rows with
   order_message 1..n and speakers agent/client, and the flash-rel kernel
   ran 24 times per fused and per mono dispatch (the flash kernel never).
   Prints VAD ms per 100 s channel, mono-ASR ms per dispatch at every
   (rows, bucket) (those the run hit marked), the segment count, the
   VAD and ASR shares, and the phase's RTFx;
9. the online server at full width: ``serving.serve`` on the card over
   phase 7's HF directory (a cache restore) and both BERT-base text
   classifiers, chunk_batch_size 16, a 20 ms batch window, warmup on.
   8 clients post 3 stereo PCM16 calls each back to back (20, 60 and
   100 s; one client at 8 kHz, one on the OpenAI-compatible route; half
   the requests with sentiment): every response 200 with its own
   audio's duration, chunk count and end times, text predictions exactly
   on transcripts of >= 5 characters, 24 requests and fewer batches in
   /v1/stats. Then one 20 s request alone 5 times; one 100 s call
   streamed in 0.5 s pieces (through gRPC where ``grpc`` imports, else
   through ``StreamingChunker`` and ``submit_chunks`` in the script),
   with ``split_audio``'s boundaries; a burst of 6 x 60 s against a
   2-chunk queue cap (503 with Retry-After); ``close()`` with 3 requests
   in flight (they finish, a new one gets 503); the device probes.
   Prints warmup s, serving RTFx, p50/p95 latency, requests per batch,
   the idle latency and device memory %; flash-rel launches = 24 x the
   fused dispatches after the warmup;
10. fine-tuning at full width: ``training.finetune.finetune`` from phase
   7's HF directory (a ``torch_converted/`` restore) on 16 synthetic
   utterances of 5-25 s (one at 8 kHz) with Darija-vocabulary
   transcripts and 8 eval ones, FinetuneConfig's batch (8) and length
   (25 s), SpecAugment on, bf16: 6 steps with a checkpoint and an eval
   every 3; a resume that runs no step (params, moments and step
   bitwise; save and restore timed); a resume to 8 steps that runs steps
   6 and 7 alone. It fails unless every loss is finite, every step-0
   gradient is finite and the q, k, v and distance-embedding gradients
   are non-zero in every layer, ``step_6/metadata.json`` holds the eval's
   WER, CER and loss, and neither attention kernel was launched. Prints
   the median step wall over steps 1-5 split into batch prep,
   forward+backward and optimizer, training RTFx, valid and padded
   frames per second, the model-FLOP share of bf16 peak, peak memory as
   a share of the card, and the state's save and restore seconds;
11. multi-process and sharded, after this process frees phases 5-10's
   models. Processes are this script's rank workers (parallel/launch.py:
   started together, killed together on a failure or a time-out), with
   NCCL when each rank has a card and gloo, named and printed, where they
   share the one card. 11a: ``DataProcessor.run`` over phase 5's 8 calls
   in 2 processes: each process's markers are its ``owns_call`` share,
   the shares disjoint and covering, the rows phase 5's with ids equal on
   every frame clear of a near tie in both runs, flash_rel launches = 24
   x each process's batches; prints the e2e RTFx beside phase 5's. 11b:
   ``ASREngine`` over a ``data: 2`` mesh (two cards, else both replicas
   on cuda:0) against one replica on the same 25 s chunks: ids equal off
   near ties, each replica launching the kernel, wall per 16-chunk slice
   of each. 11c: fine-tuning under ``mesh_shape: {data: 2}`` with ZeRO-1
   from phase 7's HF directory (full width, 24 layers, bf16, remat), 2
   steps on a global batch of 8 x 25 s, losses within 2e-3 of one
   process; the resume point consolidated on rank 0 loads into one
   process and a 0-step resume is bitwise; prints both step walls, the
   gradient all-reduce's bytes and time, each rank's peak memory. 11d:
   tensor parallel (model=2), sequence parallel (seq=2) and GPipe (2
   stages x 4 microbatches) at world 2, fp32, full width with 4 layers,
   one step each against one process on this card (loss, params, the
   pipelined forward). 11e: ``entry()`` at the full geometry (24
   flash_rel launches), ``dryrun_multichip(2)``, ``python -m
   audio_processor_tpu_torch.entry --devices 2`` with no ``--device``
   (it must run on the card), and ``make_mesh(n_devices=1)`` with no
   devices (it must hold cuda:0). 11f: the device ``resample`` against
   ``resample_np`` (8, 44.1, 48 kHz to 16 kHz);
12. the device acoustic heads (``models/sklearn_infer.py``'s torch
   functions) on the card against the port's numpy heads, which the
   pipeline runs: converted dicts built from the seed (no sklearn on the
   card) of a StandardScaler, a 4-class RBF SVC with 1,500 support
   vectors of 38 dims and Platt coefficients, and a 100-tree forest of
   depth <= 20, through ``scaler_transform``, ``svc_predict_proba`` /
   ``svc_predict`` and ``forest_predict_proba`` / ``forest_predict`` at
   B = 48: probabilities within 1e-5, labels equal away from ties; prints
   ms per call on the card beside the numpy heads';
13. SeamlessM4T v2 speech-to-text (``models/seamless_s2t.py``) at its
   published widths on one 48-row batch of 25 s chunks: the speech
   encoder's graph equals its eager body bit for bit with 24 flash_rel
   launches per call, and 103 graph-replayed decode steps equal the loop
   run eagerly step by step (tokens, and logits at three steps, bit for
   bit, the key's step graph captured once in the first loop's one
   ``decoder.graph`` span); the decode-attention kernel
   (``csrc/decode_attention.cu``) against its plain version at 48 rows x
   16 heads (self at positions
   0/31/32/102, cross over 161 frames, 157 valid and ragged rows, one with
   none; bf16 and fp32), its us per launch beside its byte bound, the
   plain version's and the library's (``scaled_dot_product_attention``),
   48 launches tallied per step graph and in each ``decoder.graph`` span,
   the wrapper's count over one graph-replayed ``generate`` (48 per step,
   equal to the spans' sum), the kernels one replayed step runs (a
   ``torch.profiler`` window around one replay); host and card ms per
   step, eager and replayed (``--only s2t`` runs phases 1, 2 and 13
   alone);
14. the topic LM (``models/moe_lm.py``) at Moonlight-16B-A3B's published
   widths (15.96 B parameters, bf16) as the local topic backend: one
   analysis batch of the topics cell's 8 calls through
   ``TopicClassifier.infer_batch`` twice (the decode step graphs captured,
   then only replayed), each prompt's first token and two decode steps
   against the plain fp32 reference read one layer at a time (logit
   error, expert ties and mismatches), the kernels one replayed step
   launches, ms per step, per batch, and the peak memory; every
   ``topics.graph`` span's ``mla_launches`` is 27 x its steps. Before it,
   14b holds the topic LM's MLA decode kernels (``models/mla_decode.py``)
   against their plain versions at the cell's shapes (8 rows, capacities
   1,536 and 4,096, ragged positions, a mask with holes, a CUDA graph of
   27 layers' decodes replayed equal to eager) and times them over 27
   layers' caches beside their byte bounds, their plain versions, the
   one SDPA call that computes the attention and the decode's composition
   before the kernels (``--only topics`` runs phases 1, 2, 14b and 14
   alone, ``--only mla`` phases 1, 2 and 14b);
15. the Kimi-Linear hybrid's kernels (``--only kimi`` runs phases 1, 2
   and 15 alone): 15a the KDA decode kernel (``csrc/kda_decode.cu``) at
   32 heads of 128 over 8 rows, a KDA layer at published widths (hidden
   2,304, bf16 stand-in weights): a prefill of a 300-token row (the
   chunked fp32 form) then 4 decode steps by the kernel against the
   prefill of all 304 tokens (states, outputs) and against the plain
   twin (outputs within a bf16 step, states within 1e-5, conv states bit
   for bit); then us per launch over 20 layers' states in a graph beside
   the byte bound and the twin's; 15b the MLA kernels at 32 heads without
   rotation (8 rows, capacities 1,536 and 4,096) against their plain
   versions and SDPA, us per launch beside the byte bound; 15c one
   graph-replayed ``generate`` of a 27-layer hybrid at published widths
   with 8 of the 256 experts held, whose every ``topics.graph`` span has
   ``kda_launches`` 20 x its steps and ``mla_launches`` 7 x its steps,
   and 20 launches of the prefill kernel a generate; 15d the KDA prefill
   kernel (``csrc/kda_prefill.cu``) against its plain twin over 8 ragged
   rows of ~1,270 and ~3,960 tokens (the topics prompts) at published
   widths (output within a bf16 step, each state within 1e-7 relative
   MSE, conv states bit for bit), then ms a layer beside the twin's and
   the bound (operations at 67 TFLOP/s of fp32 FFMA or bytes at 3.35
   TB/s).

Kernel launch counts are set to 0 just before each of the paths 5, 5b,
6, 7, 7c, 8, 10, 11a (in each process) and 11e, before phase 13's
traced ``generate`` and phase 14's two batches, and after phase 9's
warmup, and read just after;
11b counts each replica's launches. The second-to-last line is the kernels' JSON record (per kernel: launches,
error, ms, plain ms, the bound computed from the timed inputs and what
sets it, and the library call's ms or null); the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX and nothing of the JAX package ``audio_processor_tpu``.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import csv
import dataclasses
import importlib.util
import json
import logging
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
SOURCES = ("flash_rel_attention", "flash_attention", "flash_rel_parts",
           "decode_attention", "add_layer_norm", "mla_decode", "kda_decode",
           "kda_prefill")
# Kernel vs plain: fp32 holds the JAX tests' tolerance (only summation
# order differs); bf16 outputs may differ by one bf16 rounding (2^-8 to
# 2^-7 relative) since both sides compute in fp32 and round at the end.
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
MARGIN = 1e-3          # ids compared where the reference's top-2 margin is wider
INT8_MARGIN = 1e-2     # the same under int8 (an int8 step moves logits ~1e-3)
FEAT_ATOL = 2e-4       # acoustic features, relative to max(|ref|, 1)
# (encoder rows B, frames L) of every kernel call in the main-path phase:
# 3 views x (16, 8 or 4 chunks) at the 25 s (1280) and 5 s (256) buckets.
MAIN_SHAPES = [(12, 256), (12, 1280), (24, 256), (24, 1280), (48, 1280)]
# Every (rows, frames) of the message path's mono-rows program: 12, 24 or
# 48 rows at each bucket's frames (5 to 25 s); a superset of MAIN_SHAPES.
MESSAGE_SHAPES = [(b, n) for b in (12, 24, 48)
                  for n in (256, 512, 768, 1024, 1280)]
VAD_TOL = 1e-4         # PyanNet / energy VAD probabilities, card vs CPU (fp32)
LOGP_TOL = 1e-4        # tiny engine's fp32 log posteriors, card vs CPU
# Every (B, L) the flash kernel is checked at in bf16 (a superset of the
# batch path's shapes).
FLASH_SHAPES = [(b, n) for b in (12, 24, 48) for n in (256, 1280)]
# Ablation kernel vs twin (bf16 out, outputs ~0.5): one bf16 rounding of
# the output and of p, at the same kv steps on both sides.
PARTS_TOL = (4e-3, 1e-2)
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3 rate (NVIDIA's data sheet)
BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak (same)
FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores (same)
ABLATION_VARIANTS = ("full", "noselect", "norel", "nomax", "nosoftmax",
                     "noexp", "kb640", "bare:ones", "bare:reduce",
                     "shipped", "stock")
# The reference's raw text-classifier labels (host/aggregation.py maps
# them to display labels).
CLIENT_LABELS = ("content", "mécontent", "neutre", "très mécontent")
AGENT_LABELS = ("aggressive", "courtois", "neutre", "sec")
TEXT_PROB_TOL = 1e-4   # text probabilities, card vs CPU (fp32, no TF32)
# The production configuration's published widths: the ASR model at
# w2v-bert-2.0's, the text classifiers at BERT-base's (the port's
# W2VBertConfig and BertConfig defaults).
W2V_BERT_2 = {"hidden": 1024, "layers": 24, "heads": 16, "ffn": 4096}
BERT_BASE = {"hidden": 768, "layers": 12, "heads": 12, "ffn": 3072}
DEVICE = "cuda"        # where phases 7-7c put the port (7b holds it to the CPU)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def card() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script runs only on a CUDA device")
    log(smi_line())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}")
    return torch.cuda.get_device_name(0)


def build() -> None:
    from audio_processor_tpu_torch import _build

    t0 = time.perf_counter()
    libs = _build.build_all(SOURCES, native=True)
    log(f"[build] {', '.join(SOURCES)} (parallel nvcc) and the native I/O "
        f"library (g++, beside them): {time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        log(_build.build_log(name).rstrip())
    log(f"[build] native I/O library: {libs['native'].relative_to(REPO)}")
    from audio_processor_tpu_torch.io import native

    assert native.available(), "the port's native I/O library did not load"
    tensor_core_sass(libs)


def tensor_core_sass(libs: dict) -> None:
    """The bf16 attention kernels run on the tensor cores: count the
    warpgroup MMAs (HGMMA) and warp MMAs (HMMA) in each kernel's SASS
    (cuobjdump) and fail unless every tensor-core kernel has HGMMA; the
    ablation source holds only such kernels, one per config."""
    from audio_processor_tpu_torch import _build
    from audio_processor_tpu_torch.models.flash_rel_parts import MODES

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    for name in ("flash_rel_attention", "flash_attention", "flash_rel_parts"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs[name])],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
            elif fn is not None:
                ops = line.split("*/")[1].split()[:2] if "*/" in line else []
                for key in counts[fn]:
                    counts[fn][key] += any(op.startswith(key + ".")
                                           for op in ops)
        tc = {f: c for f, c in counts.items() if "_kernel_tc" in f}
        for f, c in counts.items():
            log(f"[build] SASS {name}: {f[:72]}: {c}")
        assert tc and all(c["HGMMA"] > 0 for c in tc.values()), counts
        if name == "flash_rel_parts":
            assert len(tc) == len(counts) == len(MODES), counts


def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(q, ab=None, extra_bytes: int = 0,
                    extra_flops: int = 0) -> tuple:
    """(bound ms, "bytes" or "operations") of one attention call on q's
    shape [B, H, L, 64]: q, k, v read once, o written once, ab (and the
    extra inputs) read once, over the card's 3.35 TB/s; the two products,
    4*B*H*L^2*d FLOP (plus extra_flops), over the 989 TFLOP/s bf16 peak
    (H100 SXM, NVIDIA's data sheet)."""
    B, H, L, d = q.shape
    nbytes = 4 * q.numel() * q.element_size() + extra_bytes
    if ab is not None:
        nbytes += ab.numel() * ab.element_size()
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = (4 * B * H * L * L * d + extra_flops) / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _inputs(gen, B: int, L: int, P: int, left: int, dtype, ragged: str):
    """q, k, v [B, 16, L, 64], E [P, 64] and a kv mask on the card.
    ``ragged``: "tail" masks the last 77 columns of row 1 (and all of
    row 0 when right = 0); "rows" gives every batch row its own valid
    length, as the main path's chunks of different lengths do."""
    dev = torch.device("cuda")
    q, k, v = (torch.randn(B, 16, L, 64, generator=gen).to(dev, dtype)
               for _ in range(3))
    E = torch.randn(P, 64, generator=gen).to(dev)
    mask = torch.ones(B, L)
    if ragged == "tail":
        mask[1, -min(77, L // 2):] = 0.0
        if P - 1 == left:
            mask[0] = 0.0                              # no valid kv at all
    else:
        valid = torch.randint(L // 8, L + 1, (B,), generator=gen)
        valid[0] = L                                   # one full row
        mask = (torch.arange(L)[None, :] < valid[:, None]).float()
    return q, k, v, E, mask.to(dev)


def _held(out, ref, live, tol, label: str) -> float:
    """Kernel output vs plain on the batch rows ``live`` selects, held to
    ``tol`` = (atol, rtol); the whole output must be finite. Logs and
    returns max_abs; raises on disagreement."""
    atol, rtol = tol
    err = (out[live].float() - ref[live].float()).abs()
    mag = ref[live].float().abs()
    max_abs = float(err.max())
    rel = (err / mag)[mag >= 0.1]
    max_rel = float(rel.max()) if rel.numel() else float("nan")
    used = float((err / (atol + rtol * mag)).max())
    ok = used <= 1.0 and bool(torch.isfinite(out).all())
    log(f"{label}: max_abs {max_abs:.3e}, max_rel {max_rel:.3e} where "
        f"|ref| >= 0.1; tol atol {atol:g} + rtol {rtol:g}, worst err/tol "
        f"{used:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with plain: {label}")
    return max_abs


def _compare(fra, args, left: int, P: int, label: str) -> float:
    """Kernel vs plain on the same inputs, held to TOL; returns max_abs."""
    q, _, _, _, mask = args
    out = fra.flash_rel_attention(*args, 0.125, left, P)
    ref = fra.flash_rel_attention_plain(*args, 0.125, left, P)
    torch.cuda.synchronize()
    # A batch row with no valid kv is finite but arbitrary on both sides
    # (every score sits at -1e9, where fp32 steps by 64), so only rows
    # with valid kv are compared.
    return _held(out, ref, mask.bool().any(dim=1), TOL[q.dtype],
                 f"[kernel] {str(q.dtype)[6:]:8s} {label}")


def _turns(kern, plain, label: str, reps=(20, 5)) -> tuple:
    """Kernel and plain times in turns (plain, kernel, kernel, plain);
    returns the best of each, in ms."""
    times = {"plain": [], "kernel": []}
    for name, fn, n in (("plain", plain, reps[1]), ("kernel", kern, reps[0]),
                        ("kernel", kern, reps[0]), ("plain", plain, reps[1])):
        times[name].append(_cuda_ms(fn, n))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    log(f"{label}: kernel {times['kernel']} ms, plain {times['plain']} ms "
        f"(best {ms:.3f} vs {plain_ms:.3f})")
    return ms, plain_ms


def kernel_vs_plain(seed: int) -> dict:
    from audio_processor_tpu_torch.models import flash_rel_attention as fra

    gen = torch.Generator().manual_seed(seed)
    worst = 0.0
    # (L, P, left) at B=2: the main path's table at three bucket lengths,
    # L = 64 and 320 (one q tile; an odd number of them), the largest
    # table, and two edges (one 64-row tile with a one-row table; right =
    # 0 with batch row 0 wholly masked).
    cases = [(L, 73, 64) for L in (64, 256, 320, 512, 1280)] + [
        (512, 128, 100), (64, 1, 0), (192, 9, 8)]
    for dtype in (torch.float32, torch.bfloat16):
        for L, P, left in cases:
            args = _inputs(gen, 2, L, P, left, dtype, "tail")
            worst = max(worst, _compare(
                fra, args, left, P,
                f"B= 2 H=16 L={L:4d} P={P:3d} left={left:3d} tail"))
    # Every (B, L) the batch and the message path give the kernel (bf16,
    # P=73, left=64), each batch row with its own valid length; B=48,
    # L=1280 last, whose inputs the timing below reuses.
    for B, L in MESSAGE_SHAPES:
        args = _inputs(gen, B, L, 73, 64, torch.bfloat16, "rows")
        worst = max(worst, _compare(
            fra, args, 64, 73, f"B={B:2d} H=16 L={L:4d} P= 73 left= 64 rows"))

    # Time both at the production geometry in the main path's dtype, on
    # the inputs just checked, in turns (plain, kernel, kernel, plain).
    B, H, L, P = 48, 16, 1280, 73
    q, k, v, E, mask = args
    assert tuple(q.shape) == (B, H, L, 64) and tuple(E.shape) == (P, 64)

    def kern():
        fra.flash_rel_attention(q, k, v, E, mask, 0.125, 64, P)

    def plain():
        fra.flash_rel_attention_plain(q, k, v, E, mask, 0.125, 64, P)

    ms, plain_ms = _turns(kern, plain,
                          f"[kernel] time B={B} H={H} L={L} d=64 bf16")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None,
            "bound": attention_bound(q, extra_bytes=E.numel() * 2
                                     + mask.numel() * 4,
                                     extra_flops=2 * q[..., 0].numel()
                                     * P * 64)}


def flash_vs_plain(seed: int) -> dict:
    """Phase 3b: the flash kernel against its plain version, with the
    bias the model builds (relative logits + kv mask, bf16)."""
    from audio_processor_tpu_torch.models import flash_attention as fa
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v

    cfg = w2v.W2VBertConfig()
    gen = torch.Generator().manual_seed(seed + 2)

    def case(B, L, dtype, ragged, bias=True):
        q, k, v, E, mask = _inputs(gen, B, L, 73, 64, dtype, ragged)
        if ragged == "tail":
            mask[0] = 0.0                          # a wholly masked row
        attn_bias = ((1.0 - mask) * -1e9)[:, None, None, :]
        ab = (w2v.flash_bias(cfg, q, E.to(dtype), attn_bias, 0.125)
              if bias else None)
        return q, k, v, ab, mask

    def check(args, label):
        q, k, v, ab, mask = args
        out = fa.flash_attention(q, k, v, ab, 0.125)
        ref = fa.flash_attention_plain(q, k, v, ab, 0.125)
        torch.cuda.synchronize()
        live = (mask.bool().any(dim=1) if ab is not None
                else torch.ones(q.shape[0], dtype=torch.bool))
        return _held(out, ref, live, TOL[q.dtype],
                     f"[flash] {str(q.dtype)[6:]:8s} B={q.shape[0]:2d} H=16 "
                     f"L={q.shape[2]:4d} {label}")

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for L in (64, 256, 320, 512, 1280):
            worst = max(worst, check(case(2, L, dtype, "tail"),
                                     "bias, ragged mask, row 0 masked"))
        for L in (64, 320, 1280):
            worst = max(worst, check(case(2, L, dtype, "tail", bias=False),
                                     "no bias"))
    # The no-bias instance at the ablation path's shape (its "stock").
    worst = max(worst, check(case(48, 1280, torch.bfloat16, "rows",
                                  bias=False), "no bias"))
    # Every (B, L) of the batch path under flash, bf16, each batch row
    # with its own valid length; B=48, L=1280 last, timed below.
    for B, L in FLASH_SHAPES:
        args = case(B, L, torch.bfloat16, "rows")
        worst = max(worst, check(args, "bias, rows"))
    q, k, v, ab, _ = args
    assert tuple(ab.shape) == (48, 16, 1280, 1280)
    ms, plain_ms = _turns(
        lambda: fa.flash_attention(q, k, v, ab, 0.125),
        lambda: fa.flash_attention_plain(q, k, v, ab, 0.125),
        "[flash] time B=48 H=16 L=1280 d=64 bf16, bf16 bias")
    # The one PyTorch call of the same function, on the same inputs, as a
    # yardstick (the port never calls it): SDPA computes q.k^T * scale +
    # mask, so the bias is scaled outside the timed call.
    mask_ab = ab * 0.125
    library_ms = min(_cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask_ab, scale=0.125), 20) for _ in range(2))
    log(f"[flash] library scaled_dot_product_attention(attn_mask=ab*scale):"
        f" {library_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound": attention_bound(q, ab=ab)}


def _same_nonfinite(out, ref, label: str) -> float:
    """A wrong-by-design ablation: the same NaN and signed-inf pattern,
    and PARTS_TOL where finite; returns max_abs over finite entries."""
    o, r = out.float(), ref.float()
    same = all(torch.equal(f(o), f(r)) for f in (
        torch.isnan, torch.isposinf, torch.isneginf))
    fin = torch.isfinite(r)
    atol, rtol = PARTS_TOL
    max_abs, used = 0.0, 0.0
    if fin.any():
        err = (o[fin] - r[fin]).abs()
        max_abs = float(err.max())
        used = float((err / (atol + rtol * r[fin].abs())).max())
    ok = same and used <= 1.0
    log(f"{label}: NaN {int(r.isnan().sum())}, inf {int(r.isinf().sum())}"
        f" of {r.numel()}, patterns equal {same}; finite {int(fin.sum())}:"
        f" max_abs {max_abs:.3e}, worst err/tol {used:.3f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with plain: {label}")
    return max_abs


def parts_vs_plain(seed: int) -> dict:
    """Phase 3c: every ablation kernel against its plain twin at B=2 and
    B=48 (H=16, L=1280), then both timed at B=48."""
    from audio_processor_tpu_torch.models import flash_rel_parts as frp

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)

    def inputs(B, offset=0.0):
        """bf16 q, k (+ offset), v ~ N(0, 1), s_rel ~ 4 N(0, 1), the last
        77 kv columns of batch row 1 masked."""
        q, k, v = (torch.randn(B, 16, 1280, 64, generator=gen,
                               device="cuda") for _ in range(3))
        q, k, v = ((t + o).to(torch.bfloat16)
                   for t, o in ((q, offset), (k, offset), (v, 0.0)))
        s_rel = 4.0 * torch.randn(B, 16, 1280, 128, generator=gen,
                                  device="cuda")
        mask = torch.ones(B, 1280, device="cuda")
        mask[1, -77:] = 0.0
        return q, k, v, s_rel, mask

    def kernel(name, args):
        if name.startswith("bare"):
            return frp.bare(*args[:3], rowsum=name.split(":")[1])
        if name == "kb640":
            return frp.kb640(*args)
        return frp.variant(*args, mode=name)

    worst = {name: 0.0 for name in frp.MODES}
    # At B=2, then at the ablation path's B=48, whose inputs are timed.
    for B in (2, 48):
        base, positive = inputs(B), inputs(B, offset=1.0)
        for name in frp.MODES:
            # nosoftmax on q.k > 0: unmasked rows finite, row 1 +-inf.
            args = positive if name == "nosoftmax" else base
            out, ref = kernel(name, args), frp.plain(name, *args)
            torch.cuda.synchronize()
            label = f"[parts] {name:11s} B={B:2d} H=16 L=1280 bf16"
            if name in ("nosoftmax", "noexp"):
                err = _same_nonfinite(out, ref, label)
            else:
                err = _held(out, ref, torch.ones(B, dtype=torch.bool),
                            PARTS_TOL, label)
            worst[name] = max(worst[name], err)
        del positive, out, ref
    times = {}
    for name in frp.MODES:
        times[name] = _turns(lambda: kernel(name, base),
                             lambda: frp.plain(name, *base),
                             f"[parts] time {name:11s} B=48 H=16 L=1280",
                             reps=(5, 2))
    q, _, _, s_rel, mask = base
    bounds = {"bare": attention_bound(q),
              "rel": attention_bound(q, extra_bytes=s_rel.numel() * 4
                                     + mask.numel() * 4)}
    return {"max_abs_err": worst, "times": times, "bounds": bounds,
            "library": parts_library(frp, base)}


def parts_library(frp, args) -> dict:
    """The one PyTorch call of each ablation function on the same inputs,
    as a yardstick (the port never calls it): SDPA computes
    softmax(q.k^T * scale + mask) v, so the mask is the twin's additive
    term, ``rel * scale + (kv_mask - 1) * 1e9`` in bf16 (as the flash
    row's call), built outside the timed call: full and kb640 (the same
    function) with the saturated bias, norel with the kv term alone
    (broadcast over heads and rows), bare with none. Each library output
    is logged against the twin, for information."""
    q, k, v, s_rel, kv_mask = args
    B, H, L, _ = q.shape
    pos = torch.arange(L, device=q.device)
    idx = (pos[None, :] - pos[:, None]).clamp(
        -frp.LEFT, frp.NUM_BUCKETS - 1 - frp.LEFT) + frp.LEFT
    kv_term = (kv_mask[:, None, None, :] - 1.0) * 1e9
    full_mask = torch.empty(B, H, L, L, dtype=torch.bfloat16,
                            device=q.device)
    for b in range(B):
        full_mask[b] = (s_rel[b].gather(-1, idx.expand(H, L, L))
                        * frp.SCALE + kv_term[b])
    masks = {"full": full_mask, "norel": kv_term.to(torch.bfloat16),
             "bare:ones": None}
    out = {}
    for name, mask in masks.items():
        def call(mask=mask):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=frp.SCALE)
        ref = frp.plain(name, q, k, v, s_rel, kv_mask)
        err = float((call().float() - ref.float()).abs().max())
        out[name] = min(_cuda_ms(call, 10) for _ in range(2))
        log(f"[parts] library scaled_dot_product_attention for {name:9s}: "
            f"{out[name]:.4f} ms; max_abs vs the twin {err:.3e}")
    del full_mask, masks
    out["kb640"] = out["full"]
    return out


def _write_calls(root: Path, seed: int, n: int, dur: float,
                 n_8k: int) -> float:
    """n stereo calls of ``dur`` seconds (the last n_8k at 8 kHz):
    tone bursts over noise, alternating speakers. Returns audio s."""
    from audio_processor_tpu_torch.io import wav

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for i in range(n):
        sr = 8000 if i >= n - n_8k else 16000
        t = np.arange(int(sr * dur)) / sr
        x = 0.02 * rng.standard_normal((2, t.size))
        on = (np.floor(t / 1.5) % 2).astype(bool)
        x[0] += 0.3 * on * np.sin(2 * np.pi * rng.uniform(120, 300) * t)
        x[1] += 0.3 * ~on * np.sin(2 * np.pi * rng.uniform(150, 350) * t)
        wav.write(root / f"call-{i:02d}.wav", x.astype(np.float32), sr)
    return n * dur


def graph_vs_eager(seed: int) -> dict:
    """Phase 3d: the encoder's CUDA graph replays against its eager body,
    bit for bit, at every main-path shape, under flash_rel, flash and
    int8 (see the module docstring); the host and card ms per call at
    48 x 1280 under flash_rel, eager and replayed."""
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.models.layer_norm import add_layer_norm
    from audio_processor_tpu_torch.obs import profiler

    dev = torch.device(DEVICE)
    base = w2v.build_synthetic(w2v.W2VBertConfig(vocab_size=78), dev,
                               seed=seed)
    per_call = 6 * base.cfg.num_hidden_layers
    arms = [("flash_rel", base, "flash_rel_attention"),
            ("flash", base, "flash_attention"),
            ("int8", w2v.quantize_model(base), "flash_rel_attention")]
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    counters = _counters()
    times = {}
    for arm, model, kernel in arms:
        impl = "flash" if arm == "flash" else "flash_rel"
        for rows, frames in MESSAGE_SHAPES:
            xs = [torch.randn(rows, frames, 160, device=dev, generator=gen)
                  for _ in range(2)]
            valid = torch.randint(frames // 2, frames + 1, (rows,),
                                  device=dev, generator=gen)
            mask = torch.arange(frames, device=dev)[None, :] < valid[:, None]
            with torch.inference_mode(), profiler.recording_spans():
                want = [model._encode(x, mask, torch.bfloat16, impl)
                        for x in xs]
                got, launched, ln = [], [], []
                seen = {sp.id for sp in profiler.spans()}
                for x in (xs[0], xs[0], xs[1]):  # capture, two replays
                    before = (counters[kernel].launches,
                              add_layer_norm.launches)
                    got.append(model(x, mask, dtype=torch.bfloat16,
                                     attention_impl=impl))
                    launched.append(counters[kernel].launches - before[0])
                    ln.append(add_layer_norm.launches - before[1])
                spans = [sp.attrs["ln_launches"] for sp in profiler.spans()
                         if sp.id not in seen and sp.name == "encoder.graph"]
            same = [torch.equal(g, w) for g, w in
                    zip(got, (want[0], want[0], want[1]))]
            if not all(same) or launched != [24, 24, 24] \
                    or ln != [per_call] * 3 or spans != ln:
                raise AssertionError(
                    f"[3d graphs] {arm} {rows}x{frames}: replay equal to "
                    f"eager {same}, launches {launched}, fused LayerNorm "
                    f"launches {ln}, spans' ln_launches {spans}")
        log(f"[3d graphs] {arm}: capture + 2 replays at "
            f"{len(MESSAGE_SHAPES)} shapes equal eager bit for bit; "
            f"{kernel} launches 24 per call; add_layer_norm {per_call} per "
            f"call, as each encoder.graph span's ln_launches reads")
        if arm == "flash_rel":
            x = torch.randn(48, 1280, 160, device=dev, generator=gen)
            mask = torch.ones(48, 1280, dtype=torch.bool, device=dev)
            for label, fn in (
                    ("eager", lambda: model._encode(x, mask, torch.bfloat16,
                                                    impl)),
                    ("replay", lambda: model(x, mask,
                                             dtype=torch.bfloat16))):
                with torch.inference_mode():
                    host = []
                    for _ in range(5):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn()
                        host.append(1e3 * (time.perf_counter() - t0))
                    card_ms = _cuda_ms(fn, 5)
                times[label] = {"host_ms": float(np.median(host)),
                                "card_ms": card_ms}
            log(f"[3d graphs] 48x1280 flash_rel: host ms to return, card "
                f"ms per call: {json.dumps(times)}")
    del arms, base, model
    torch.cuda.empty_cache()
    return times


def _bf16_steps(y: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|y - want| in bf16 steps of ``want``, a step below 2^-6 counted as
    2^-6's: near 0 the fp32 statistics' own rounding (~1e-6 at unit
    scale) exceeds a bf16 step, whatever the order of the sums."""
    mag = want.float().abs().clamp_min(2.0 ** -6)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (y.float() - want.float()).abs() / step


def add_layer_norm_check(seed: int) -> dict:
    """Phase 3e: the fused add-and-LayerNorm kernel against its plain
    version, then graph-timed at the main path's rows (see the module
    docstring). Returns the checks' worst steps and each form's times."""
    from audio_processor_tpu_torch.models import layer_norm as lnm

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 37)

    def norm(width):
        ln = torch.nn.LayerNorm(width).to(dev)
        with torch.no_grad():
            ln.weight.copy_(1 + 0.3 * torch.randn(width, device=dev,
                                                  generator=gen))
            ln.bias.copy_(0.2 * torch.randn(width, device=dev,
                                            generator=gen))
        return ln

    def rows(shape):
        x = (2 * torch.randn(shape, device=dev, generator=gen) + 0.5) \
            .bfloat16()
        a = torch.randn(shape, device=dev, generator=gen).bfloat16()
        mask = (torch.rand(shape[:-1], device=dev, generator=gen) > 0.2) \
            .float()
        return x, a, mask

    # (name, branch?, alpha, epilogue, residual): the conformer's forms;
    # "cols": x the transpose of a contiguous [B, C, L], as the depthwise
    # convolution leaves it
    forms = [("ln", False, 1.0, "none", True),
             ("add_ln", True, 0.5, "none", True),
             ("add_ln_mask", True, 1.0, "mask", True),
             ("add_ln_final", True, 0.5, "none", False),
             ("ln_silu", False, 1.0, "silu", True),
             ("ln_silu_cols", False, 1.0, "silu", True)]

    def laid(x, name):
        return x.transpose(1, 2).contiguous().transpose(1, 2) \
            if name.endswith("_cols") else x
    worst = {}
    with torch.inference_mode():
        for shape in ((48, 1280, 1024), (24, 97, 1024), (24, 104, 1024),
                      (24, 97, 4096), (24, 97, 72)):
            ln = norm(shape[-1])
            x, a, mask = rows(shape)
            for name, has_branch, alpha, epi, residual in forms:
                xi = laid(x, name)
                branch = a if has_branch else None
                m = mask if epi == "mask" else None
                r, y = lnm.add_layer_norm(ln, xi, branch, alpha, mask=m,
                                          silu=epi == "silu",
                                          residual=residual)
                pr, py = lnm.add_layer_norm_plain(
                    ln, xi, branch, alpha, mask=m, silu=epi == "silu",
                    residual=residual)
                assert (torch.equal(r, pr) if residual else r is None), \
                    (shape, name)
                # the epilogue on the kernel's own y, and that y (the
                # no-epilogue form) against the plain version's; columns
                # give the rows' y bit for bit
                _, y0 = lnm.add_layer_norm(ln, xi, branch, alpha)
                _, py0 = lnm.add_layer_norm_plain(ln, xi, branch, alpha)
                if xi is not x:
                    assert torch.equal(y0, lnm.add_layer_norm(ln, x)[1]), \
                        (shape, name)
                if epi == "mask":
                    assert torch.equal(y, y0 * m[..., None].bfloat16()), \
                        (shape, name)
                elif epi == "silu":
                    assert torch.equal(y, F.silu(y0)), (shape, name)
                pre, post = _bf16_steps(y0, py0), _bf16_steps(y, py)
                key = f"{'x'.join(map(str, shape))}.{name}"
                worst[key] = {"steps": float(pre.max()),
                              "differ": int((pre > 0).sum()),
                              "epilogue_steps": float(post.max()),
                              "max_abs_err": float((y.float() - py.float())
                                                   .abs().max())}
                assert worst[key]["steps"] <= 1, (key, worst[key])
            del x, a, mask
    log(f"[3e layer norm] kernel = plain (r bit for bit; y's bf16 steps, "
        f"elements that differ; the epilogue's steps): "
        f"{json.dumps(worst)}")

    ln = norm(1024)
    x, a, mask = rows((48, 1280, 1024))
    lw, lb = ln.weight.bfloat16(), ln.bias.bfloat16()
    act = x.numel() * x.element_size()
    timed = {}
    with torch.inference_mode():
        for name, has_branch, alpha, epi, residual in forms:
            branch = a if has_branch else None
            xi = laid(x, name)
            kw = dict(mask=mask if epi == "mask" else None,
                      silu=epi == "silu", residual=residual)
            nbytes = act * (2 + has_branch + (has_branch and residual)) \
                + (mask.numel() * 4 if epi == "mask" else 0)

            def library(branch=branch, alpha=alpha, xi=xi):
                r = xi if branch is None else torch.add(xi, branch,
                                                        alpha=alpha)
                return F.layer_norm(r, (1024,), lw, lb, ln.eps)

            timed[name] = {
                "ms": _graph_ms(lambda: lnm.add_layer_norm(
                    ln, xi, branch, alpha, **kw), 50),
                "plain_ms": _graph_ms(lambda: lnm.add_layer_norm_plain(
                    ln, xi, branch, alpha, **kw), 10),
                "library_ms": _graph_ms(library, 50),
                "bound_ms": 1e3 * nbytes / HBM_BYTES_S, "bytes": nbytes}
    log(f"[3e layer norm] ms per launch at 48 x 1280 x 1024 bf16 (bound: "
        f"bytes / 3.35 TB/s): {json.dumps(timed)}")
    del x, a, mask
    torch.cuda.empty_cache()
    return {"worst": worst, "timed": timed}


def _fused_features(buf: np.ndarray, lengths: np.ndarray,
                    bucket_len: int) -> tuple:
    """The fused program's encoder input on the CPU, from a prepared
    int16 buffer [N, 2, bucket+2*PAD]: (feats, mask) of the mixed, agent
    and client rows of each chunk, in that order."""
    from audio_processor_tpu_torch.dsp.acoustic_features import PAD
    from audio_processor_tpu_torch.dsp.fbank import log_mel_frontend
    from audio_processor_tpu_torch.pipeline.asr_engine import pad_seq

    x = torch.from_numpy(buf).float() / 32768.0
    a = x[:, 0, PAD:PAD + bucket_len]
    c = x[:, 1, PAD:PAD + bucket_len]
    rows = torch.stack([(a + c) * 0.5, a, c], 1).reshape(-1, bucket_len)
    return pad_seq(*log_mel_frontend(
        rows, torch.from_numpy(lengths).repeat_interleave(3)))


def small_reference(seed: int, impl: str, quantization: str = "none"
                    ) -> None:
    """A tiny model through the engine's fused program on the card
    (CUDA kernel) and on the CPU (plain path), fp32, same inputs.
    ``impl`` is the configured attention_impl: "auto" (flash_rel on the
    card, xla on the CPU) or "flash" (on both). Under ``quantization:
    int8`` an activation on one side can round to the next int8 step
    (the two sides' fp32 differ in the last bits), so the logits are not
    bounded and ids are compared where the top-2 margin exceeds
    INT8_MARGIN."""
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.io.decode import load_audio
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.models.tokenizer import CTCVocab
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
    from audio_processor_tpu_torch.pipeline.chunker import (
        chunk_batch, prepare_and_split,
    )

    cfg = PipelineConfig.from_dict({
        "enable_mixed_precision": False, "chunk_duration_sec": 10.0,
        "overlap_sec": 1.0, "length_buckets_sec": [5.0, 10.0],
        "chunk_batch_size": 4, "attention_impl": impl,
        "quantization": quantization})
    vocab = CTCVocab.darija_default()
    mcfg = w2v.W2VBertConfig(vocab_size=len(vocab), hidden_size=128,
                             num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=256)
    cpu_model = w2v.build_synthetic(mcfg, torch.device("cpu"), seed=seed)
    gpu_model = w2v.build_synthetic(mcfg, torch.device("cpu"), seed=seed)
    cpu = ASREngine(cfg, device="cpu", model=cpu_model, vocab=vocab)
    gpu = ASREngine(cfg, device="cuda", model=gpu_model, vocab=vocab)
    assert (gpu.attention_impl, cpu.attention_impl) == {
        "auto": ("flash_rel", "xla"), "flash": ("flash", "flash")}[impl]
    tag = "[reference]" if impl == "auto" else f"[reference {impl}]"
    if quantization == "int8":
        tag = "[reference int8]"
        assert all(type(e.model.layers[0].ffn1.intermediate_dense).__name__
                   == "QuantLinear" for e in (cpu, gpu))
    margin, logit_tol = ((INT8_MARGIN, float("inf"))
                         if quantization == "int8" else (MARGIN, 1e-4))
    with tempfile.TemporaryDirectory() as tmp:
        _write_calls(Path(tmp) / "in", seed + 1, 1, 23.0, 1)
        wave, sr = load_audio(Path(tmp) / "in" / "call-00.wav")
    _, _, chunks = prepare_and_split(wave, sr, "ref.wav", cfg)
    for batch in chunk_batch(chunks, cpu.bucket_samples):
        n = len(batch)
        buf, lengths = cpu._prepare_fused_buffer(batch,
                                                 cpu._tail_size(n))
        ids_c, mask_c, af_c = cpu._fused(torch.from_numpy(buf),
                                         torch.from_numpy(lengths),
                                         batch.bucket_len)
        ids_g, mask_g, af_g = (t.cpu() for t in gpu._fused(
            gpu._upload(buf), gpu._upload(lengths), batch.bucket_len))
        assert torch.equal(mask_c, mask_g), "masks differ"
        # Logits of the CPU run decide which frames are near ties.
        feats, mask = _fused_features(buf, lengths, batch.bucket_len)
        with torch.inference_mode():
            logits = cpu.model(feats, mask, attention_impl=cpu.attention_impl)
            logits_g = gpu.model(feats.cuda(), mask.cuda(),
                                 attention_impl=gpu.attention_impl).cpu()
        real = slice(0, 3 * n)
        top2 = logits.topk(2, dim=-1).values
        clear = ((top2[..., 0] - top2[..., 1]) > margin)[real]
        dlog = float((logits_g - logits)[real][mask[real]].abs().max())
        same = bool(torch.equal(ids_c[real][clear], ids_g[real][clear]))
        scale = af_c[:n].abs().clamp_min(1.0)
        dfeat = float(((af_g[:n] - af_c[:n]) / scale)
                      .nan_to_num(0.0).abs().max())
        log(f"{tag} bucket {batch.bucket_len}, {n} chunk(s): logits "
            f"max_abs {dlog:.3e} (tol {logit_tol:g}); ids equal on "
            f"{int(clear.sum())}/{clear.numel()} clear frames: {same}; "
            f"features max rel {dfeat:.3e} (tol {FEAT_ATOL:g})")
        if not (dlog <= logit_tol and same and dfeat <= FEAT_ATOL
                and int(clear.sum()) > 0):
            raise AssertionError("card and CPU disagree on the small input")


def _counters() -> dict:
    """Kernel name -> the wrapper whose ``launches`` counts its launches."""
    from audio_processor_tpu_torch.models import flash_rel_parts as frp
    from audio_processor_tpu_torch.models.decode_attention import (
        decode_attention,
    )
    from audio_processor_tpu_torch.models.flash_attention import (
        flash_attention,
    )
    from audio_processor_tpu_torch.models.flash_rel_attention import (
        flash_rel_attention,
    )
    from audio_processor_tpu_torch.models.layer_norm import add_layer_norm
    from audio_processor_tpu_torch.models.kda import kda_decode, kda_prefill
    from audio_processor_tpu_torch.models.mla_decode import (
        mla_decode_attention,
        mla_decode_prep,
    )

    return {"kda_decode": kda_decode, "kda_prefill": kda_prefill,
            "flash_rel_attention": flash_rel_attention,
            "flash_attention": flash_attention, "kb640": frp.kb640,
            "bare": frp.bare, "variant": frp.variant,
            "decode_attention": decode_attention,
            "add_layer_norm": add_layer_norm,
            "mla_decode_prep": mla_decode_prep,
            "mla_decode_attention": mla_decode_attention}


def _reset_launches() -> None:
    for wrapper in _counters().values():
        wrapper.launches = 0


def _launches() -> dict:
    return {name: wrapper.launches for name, wrapper in _counters().items()}


def main_path(seed: int, impl: str, n_calls: int, n_8k: int) -> dict:
    """The batch path at full width under the configured attention_impl
    ("auto": the flash_rel kernel; "flash": the flash kernel on a
    materialised bias); launch counts set to 0 just before the run."""
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.dsp.fbank import max_num_frames
    from audio_processor_tpu_torch.models.wav2vec2bert import W2VBertConfig
    from audio_processor_tpu_torch.pipeline.engine import DataProcessor

    resolved = {"auto": "flash_rel", "flash": "flash"}[impl]
    kernel, other = (("flash_rel_attention", "flash_attention")
                     if resolved == "flash_rel"
                     else ("flash_attention", "flash_rel_attention"))
    tag = "[main]" if impl == "auto" else f"[main {impl}]"
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        audio_s = _write_calls(root / "input", seed, n_calls, 100.0, n_8k)
        cfg = PipelineConfig.from_dict({
            "input_folder": str(root / "input"),
            "output_folder": str(root / "output"),
            "logs_folder": str(root / "logs"),
            "temp_dir": str(root / "tmp"),
            "chunk_batch_size": 16, "enable_mixed_precision": True,
            "save_csv_results": True, "attention_impl": impl})
        proc = DataProcessor(cfg, device="cuda")
        try:
            t0 = time.perf_counter()
            proc.setup_models()
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            engine = proc.asr_engine
            mcfg = engine.model_cfg
            assert mcfg == W2VBertConfig(vocab_size=mcfg.vocab_size)
            assert engine.attention_impl == resolved
            assert engine.dtype == torch.bfloat16

            _reset_launches()
            engine.dispatches = 0
            t0 = time.perf_counter()
            succeeded = proc.run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = _launches()
            stats = dict(proc.stats)
            dispatches, warmed = engine.dispatches, set(engine._warmed)
            spy = (_untimed_ids(proc, (root / "input").glob("*.wav"))
                   if impl == "auto" else None)
        finally:
            proc.close()
        (csv_path,) = (root / "output").glob("optimized_results_*.csv")
        with open(csv_path, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f))

    launches = counts[kernel]
    ln = counts["add_layer_norm"]
    log(f"{tag} model: hidden {mcfg.hidden_size}, layers "
        f"{mcfg.num_hidden_layers}, heads {mcfg.num_attention_heads}, "
        f"ffn {mcfg.intermediate_size}, conv {mcfg.conv_depthwise_kernel_size}"
        f", vocab {mcfg.vocab_size}; setup {setup_s:.2f} s")
    shapes = sorted(  # (encoder rows, frames) per (bucket, chunks) shape
        (3 * n, -(-max_num_frames(b) // 2 // 256) * 256)
        for b, n in warmed)
    log(f"{tag} files succeeded {succeeded}/{n_calls}, chunk rows "
        f"{len(rows)}, batches dispatched {dispatches} (warmup "
        f"included), encoder batch shapes {shapes}")
    log(f"{tag} {resolved} launches {launches} = 24 x {dispatches}"
        f": {launches == mcfg.num_hidden_layers * dispatches}; "
        f"add_layer_norm launches {ln} = 144 x {dispatches}: "
        f"{ln == 6 * mcfg.num_hidden_layers * dispatches}; "
        f"all launch counts {counts}")
    log(f"{tag} wall {wall_s:.2f} s for {audio_s:.0f} s of audio "
        f"(warmup included): RTFx {audio_s / wall_s:.1f}")
    per_file = {}
    for r in rows:
        per_file[r["file_name"]] = per_file.get(r["file_name"], 0) + 1
    assert succeeded == n_calls and stats["files_success"] == n_calls, stats
    assert stats["errors"] == 0, stats
    # 100 s calls, 25 s chunks with 1 s overlap: starts 0, 24, 48, 72, 96
    assert per_file == {f"call-{i:02d}.wav": 5
                        for i in range(n_calls)}, per_file
    assert not any(r["error"] for r in rows)
    assert (400000, 16) in warmed      # full 48 x 1280 batches ran
    # The kernel phase checked the kernel at every shape this run gave it.
    checked = MAIN_SHAPES if resolved == "flash_rel" else FLASH_SHAPES
    assert set(shapes) <= set(checked), shapes
    assert launches > 0 and launches == mcfg.num_hidden_layers \
        * dispatches
    assert ln == 6 * mcfg.num_hidden_layers * dispatches, counts
    assert all(n == 0 for name, n in counts.items()
               if name not in (kernel, "add_layer_norm")), counts
    assert "jax" not in sys.modules
    return {"launches": launches, "ln_launches": ln, "other": counts[other],
            "rows": spy and spy.rows,
            "rtfx": audio_s / wall_s}


def ablation_path(seed: int) -> dict:
    """Phase 6: the ablation tool's entry point over all its variants at
    B=48, H=16, L=1280; launch counts set to 0 just before it."""
    tool = _load_tool("profile_kernel_parts_torch")
    _reset_launches()
    ms = tool.run(ABLATION_VARIANTS, seed=seed)
    torch.cuda.synchronize()
    counts = _launches()
    per = tool.REPS * (tool.ROUNDS + 1)      # a warm-up loop, then ROUNDS
    expect = {"flash_rel_attention": per, "flash_attention": per,
              "kb640": per, "bare": 2 * per, "variant": 6 * per,
              "decode_attention": 0, "add_layer_norm": 0,
              "mla_decode_prep": 0, "mla_decode_attention": 0,
              "kda_decode": 0, "kda_prefill": 0}
    log(f"[ablation] launches {counts} (expected {expect})")
    assert counts == expect, counts
    return {"launches": counts, "ms": ms}


# ---------------------------------------------------------------- phase 7
_ST_DTYPE = {torch.float32: "F32", torch.int64: "I64"}


def write_safetensors(path: Path, tensors: dict) -> None:
    """A ``.safetensors`` file: 8-byte little-endian header length, the
    JSON header (dtype, shape, byte range of each tensor), the buffers."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPE[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            t.contiguous().numpy().tofile(f)


class _Weights:
    """Seeded fp32 tensors under HF names, each beside the name the port's
    model gives it (None where the model has no such tensor)."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(seed)
        self.hf: dict = {}
        self.port: dict = {}

    def add(self, hf_name, shape, port_name=None, kind="normal"):
        if kind == "ln_weight":
            t = 1.0 + 0.1 * torch.randn(shape, generator=self.gen)
        else:
            t = 0.02 * torch.randn(shape, generator=self.gen)
        self.hf[hf_name] = t
        if port_name is not None:
            self.port[port_name] = t

    def ln(self, hf, port, d):
        self.add(f"{hf}.weight", (d,), port and f"{port}.weight", "ln_weight")
        self.add(f"{hf}.bias", (d,), port and f"{port}.bias")

    def linear(self, hf, port, d_in, d_out, bias=True):
        self.add(f"{hf}.weight", (d_out, d_in), port and f"{port}.weight")
        if bias:
            self.add(f"{hf}.bias", (d_out,), port and f"{port}.bias")


def write_w2v_checkpoint(d: Path, seed: int, vocab: dict, hidden: int,
                         layers: int, heads: int, ffn: int) -> dict:
    """An HF ``Wav2Vec2BertForCTC`` directory (w2v-bert-2.0: hidden 1024,
    24 layers, 16 heads, FFN 4096; conv 31, relative positions 64/8):
    config.json, vocab.json, model.safetensors. Returns the port-named
    tensors that were written."""
    H, I, K, P, hd = hidden, ffn, 31, 73, hidden // heads
    w = _Weights(seed)
    w.add("wav2vec2_bert.masked_spec_embed", (H,))        # unused by CTC
    fp = "wav2vec2_bert.feature_projection"
    w.ln(f"{fp}.layer_norm", "feature_projection.layer_norm", 160)
    w.linear(f"{fp}.projection", "feature_projection.projection", 160, H)
    for i in range(layers):
        hf, pt = f"wav2vec2_bert.encoder.layers.{i}", f"layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            w.ln(f"{hf}.{ffn}_layer_norm", f"{pt}.{ffn}_layer_norm", H)
            w.linear(f"{hf}.{ffn}.intermediate_dense",
                     f"{pt}.{ffn}.intermediate_dense", H, I)
            w.linear(f"{hf}.{ffn}.output_dense", f"{pt}.{ffn}.output_dense",
                     I, H)
        w.ln(f"{hf}.self_attn_layer_norm", f"{pt}.self_attn_layer_norm", H)
        for proj in ("q", "k", "v", "out"):
            w.linear(f"{hf}.self_attn.linear_{proj}",
                     f"{pt}.self_attn.linear_{proj}", H, H)
        w.add(f"{hf}.self_attn.distance_embedding.weight", (P, hd),
              f"{pt}.self_attn.distance_embedding")
        cm, cp = f"{hf}.conv_module", f"{pt}.conv_module"
        w.ln(f"{cm}.layer_norm", f"{cp}.layer_norm", H)
        w.add(f"{cm}.pointwise_conv1.weight", (2 * H, H, 1))
        w.port[f"{cp}.pointwise_conv1.weight"] = \
            w.hf[f"{cm}.pointwise_conv1.weight"][..., 0]
        w.add(f"{cm}.depthwise_conv.weight", (H, 1, K),
              f"{cp}.depthwise_conv.weight")
        w.ln(f"{cm}.depthwise_layer_norm", f"{cp}.depthwise_layer_norm", H)
        w.add(f"{cm}.pointwise_conv2.weight", (H, H, 1))
        w.port[f"{cp}.pointwise_conv2.weight"] = \
            w.hf[f"{cm}.pointwise_conv2.weight"][..., 0]
        w.ln(f"{hf}.final_layer_norm", f"{pt}.final_layer_norm", H)
    w.linear("lm_head", "lm_head", H, len(vocab))
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps({
        "architectures": ["Wav2Vec2BertForCTC"],
        "model_type": "wav2vec2-bert", "vocab_size": len(vocab),
        "hidden_size": H, "num_hidden_layers": layers,
        "num_attention_heads": heads, "intermediate_size": I,
        "feature_projection_input_dim": 160,
        "conv_depthwise_kernel_size": K,
        "position_embeddings_type": "relative_key",
        "left_max_position_embeddings": 64,
        "right_max_position_embeddings": 8, "layer_norm_eps": 1e-5,
        "pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 2}))
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False),
                                  encoding="utf-8")
    write_safetensors(d / "model.safetensors", w.hf)
    return w.port


def bert_vocab(ctc_vocab: dict, size: int) -> list:
    """A BERT-style vocab.txt of ``size`` lines: [PAD], [unused*], [UNK],
    [CLS], [SEP], [MASK] at BERT-base's ids, then the Darija characters,
    digits and Latin letters whole and as ``##`` pieces, then fillers."""
    chars = [t for t in ctc_vocab if len(t) == 1 and t != "|"]
    toks = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars
            + ["##" + c for c in chars] + list(".,!?،؟"))
    return toks + [f"[unused{i}]" for i in range(99, 99 + size - len(toks))]


def write_bert_checkpoint(d: Path, seed: int, labels, vocab: list,
                          hidden: int, layers: int, heads: int, ffn: int,
                          positions: int = 512) -> None:
    """An HF ``BertForSequenceClassification`` directory (BERT-base at the
    defaults): config.json with ``id2label``, model.safetensors (with the
    ``position_ids`` buffer older checkpoints carry), vocab.txt and
    tokenizer_config.json."""
    w = _Weights(seed)
    e = "bert.embeddings"
    w.add(f"{e}.word_embeddings.weight", (len(vocab), hidden))
    w.add(f"{e}.position_embeddings.weight", (positions, hidden))
    w.add(f"{e}.token_type_embeddings.weight", (2, hidden))
    w.ln(f"{e}.LayerNorm", None, hidden)
    for i in range(layers):
        p = f"bert.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            w.linear(f"{p}.attention.self.{n}", None, hidden, hidden)
        w.linear(f"{p}.attention.output.dense", None, hidden, hidden)
        w.ln(f"{p}.attention.output.LayerNorm", None, hidden)
        w.linear(f"{p}.intermediate.dense", None, hidden, ffn)
        w.linear(f"{p}.output.dense", None, ffn, hidden)
        w.ln(f"{p}.output.LayerNorm", None, hidden)
    w.linear("bert.pooler.dense", None, hidden, hidden)
    w.add("classifier.weight", (len(labels), hidden))
    w.hf["classifier.weight"] *= 50.0          # visibly unequal classes
    w.add("classifier.bias", (len(labels),))
    w.hf[f"{e}.position_ids"] = torch.arange(positions)[None]
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps({
        "architectures": ["BertForSequenceClassification"],
        "model_type": "bert", "vocab_size": len(vocab),
        "hidden_size": hidden, "num_hidden_layers": layers,
        "num_attention_heads": heads, "intermediate_size": ffn,
        "max_position_embeddings": positions, "type_vocab_size": 2,
        "layer_norm_eps": 1e-12, "hidden_act": "gelu",
        "id2label": {str(i): lab for i, lab in enumerate(labels)},
        "label2id": {lab: i for i, lab in enumerate(labels)}},
        ensure_ascii=False), encoding="utf-8")
    write_safetensors(d / "model.safetensors", w.hf)
    (d / "vocab.txt").write_text("\n".join(vocab), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": True, "tokenizer_class": "BertTokenizer"}))


def write_production_models(root: Path, seed: int, asr: dict,
                            bert: dict) -> dict:
    from audio_processor_tpu_torch.models.tokenizer import CTCVocab

    t0 = time.perf_counter()
    ctc = CTCVocab.darija_default().vocab
    written = write_w2v_checkpoint(root / "asr", seed, ctc, **asr)
    vocab = bert_vocab(ctc, 30522)
    write_bert_checkpoint(root / "client_text", seed + 1, CLIENT_LABELS,
                          vocab, **bert)
    write_bert_checkpoint(root / "agent_text", seed + 2, AGENT_LABELS, vocab,
                          **bert)
    write_bert_checkpoint(root / "small_text", seed + 3, CLIENT_LABELS,
                          vocab[:200], hidden=64, layers=2, heads=4,
                          ffn=128)
    size = sum(f.stat().st_size for f in root.rglob("*.safetensors"))
    log(f"[production] wrote the ASR checkpoint (w2v-bert-2.0 width) and two"
        f" BERT-base classifiers (+ a small one): {size / 1e9:.2f} GB of "
        f"safetensors in {time.perf_counter() - t0:.1f} s")
    return written


def _equal_state(model, want: dict, label: str) -> None:
    """The model's tensors equal ``want`` bit for bit, name for name."""
    got = model.state_dict()
    assert set(got) == set(want), (label, set(got) ^ set(want))
    bad = [k for k, t in want.items()
           if not torch.equal(got[k].cpu(), t)]
    log(f"[production] {label}: {len(want)} tensors, bit-equal: {not bad}")
    assert not bad, bad[:5]


@contextlib.contextmanager
def _no_reconversion():
    """Inside, ``load_or_convert_w2v_bert`` must restore from its cache."""
    from audio_processor_tpu_torch.models import checkpoint

    real = checkpoint.load_w2v_bert_from_pretrained

    def refuse(*a, **k):
        raise AssertionError("the cache was not restored")

    checkpoint.load_w2v_bert_from_pretrained = refuse
    try:
        yield
    finally:
        checkpoint.load_w2v_bert_from_pretrained = real


def _spy_rows(proc) -> list:
    """The sentiment stage's output rows (with probabilities, which the
    CSV does not keep)."""
    rows = []
    real = proc.sentiment_analyzer.analyze_batch_sentiment
    proc.sentiment_analyzer.analyze_batch_sentiment = \
        lambda chunks: rows.extend(real(chunks)) or chunks
    return rows


def production_run(models: Path, root: Path, seed: int, n_calls: int,
                   n_8k: int, tag: str, **extra) -> dict:
    """DataProcessor over n_calls 100 s calls with the checkpoint and both
    text paths set; launch counts set to 0 just before the run."""
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.pipeline.engine import DataProcessor

    audio_s = _write_calls(root / "input", seed, n_calls, 100.0, n_8k)
    cfg = PipelineConfig.from_dict({
        "input_folder": str(root / "input"),
        "output_folder": str(root / "output"),
        "logs_folder": str(root / "logs"), "temp_dir": str(root / "tmp"),
        "transcription_model": str(models / "asr"),
        "client_text_model_path": str(models / "client_text"),
        "agent_text_model_path": str(models / "agent_text"),
        "chunk_batch_size": 16, "enable_mixed_precision": True,
        "save_csv_results": True, **extra})
    proc = DataProcessor(cfg, device=DEVICE)
    try:
        t0 = time.perf_counter()
        proc.setup_models()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        engine, text = proc.asr_engine, proc.sentiment_analyzer.text_analyzer
        rows = _spy_rows(proc)
        _reset_launches()
        engine.dispatches = 0
        t0 = time.perf_counter()
        succeeded = proc.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = _launches()
        stats = dict(proc.stats)
    finally:
        proc.close()
    (csv_path,) = (root / "output").glob("optimized_results_*.csv")
    with open(csv_path, newline="", encoding="utf-8") as f:
        csv_rows = list(csv.DictReader(f))
    launches = counts["flash_rel_attention"]
    layers = engine.model_cfg.num_hidden_layers
    log(f"{tag} setup (checkpoint load, text classifiers) {setup_s:.2f} s; "
        f"files succeeded {succeeded}/{n_calls}, chunk rows {len(csv_rows)}"
        f", batches {engine.dispatches}, flash_rel launches {launches} = "
        f"{layers} x {engine.dispatches}: "
        f"{launches == layers * engine.dispatches}; text classifier runs "
        f"{dict(text.shapes_run)}")
    log(f"{tag} wall {wall_s:.2f} s for {audio_s:.0f} s of audio (warmup "
        f"included): RTFx {audio_s / wall_s:.1f}")
    assert succeeded == n_calls and stats["files_success"] == n_calls, stats
    assert stats["errors"] == 0 and not any(r["error"] for r in csv_rows)
    assert len(csv_rows) == len(rows) == 5 * n_calls, (len(csv_rows),
                                                       len(rows))
    assert text.models_available
    assert launches > 0 and launches == layers * engine.dispatches, counts
    assert counts["add_layer_norm"] == 6 * launches, counts
    assert all(n == 0 for k, n in counts.items()
               if k not in ("flash_rel_attention", "add_layer_norm")), counts
    _check_text_rows(rows, tag)
    return {"proc": proc, "engine": engine, "text": text, "rows": rows,
            "wall_s": wall_s, "audio_s": audio_s, "setup_s": setup_s,
            "launches": launches}


def _check_text_rows(rows: list, tag: str) -> None:
    """A text prediction exactly where the transcript has >= 5 stripped
    characters, and then probabilities that sum to 1 within 1e-5."""
    n_text, worst = 0, 0.0
    for r in rows:
        for speaker, labels in (("agent", AGENT_LABELS),
                                ("client", CLIENT_LABELS)):
            text = r[f"{speaker}_transcription"]
            pred = r[f"{speaker}_text_sentiment"]
            assert (pred != "") == (len(text.strip()) >= 5), (text, pred)
            if pred:
                assert pred in labels, pred
                worst = max(worst, abs(sum(
                    r[f"{speaker}_text_probabilities"]) - 1.0))
                n_text += 1
    log(f"{tag} text predictions on {n_text} of {2 * len(rows)} transcripts"
        f" (all with >= 5 characters); worst |sum(p) - 1| {worst:.2e} "
        "(tol 1e-5)")
    assert n_text > 0 and worst <= 1e-5


def _time_text(text, speaker: str, shapes) -> dict:
    """ms per classifier dispatch (the forward and its softmax) at each
    (B, L), on random token ids, by CUDA events."""
    model = text.models[speaker]["model"]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    out = {}
    for B, L in shapes:
        ids = torch.randint(0, model.cfg.vocab_size, (B, L), generator=gen,
                            device=DEVICE, dtype=torch.int32)
        mask = torch.ones(B, L, device=DEVICE)
        with torch.inference_mode():
            out[(B, L)] = _cuda_ms(lambda: torch.softmax(model(ids, mask),
                                                         -1), 5)
    return out


def production(seed: int, work: Path, asr: dict = W2V_BERT_2,
               bert: dict = BERT_BASE) -> dict:
    """Phase 7: the production configuration at full width."""
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.models.checkpoint import (
        load_or_convert_w2v_bert,
    )
    from audio_processor_tpu_torch.pipeline.sentiment import (
        TextSentimentAnalyzer,
    )

    models = work / "models"
    log(f"[production] card: {smi_line()}")
    written = write_production_models(models, seed, asr, bert)
    res = production_run(models, work / "run7", seed + 7, 4, 1,
                         "[production]")
    engine = res["engine"]
    mcfg = engine.model_cfg
    assert (mcfg.hidden_size, mcfg.num_hidden_layers,
            mcfg.num_attention_heads, mcfg.intermediate_size) == (
        asr["hidden"], asr["layers"], asr["heads"], asr["ffn"]), mcfg
    bcfg = res["text"].models["client"]["cfg"]
    assert (bcfg.hidden_size, bcfg.num_hidden_layers, bcfg.vocab_size,
            bcfg.max_position_embeddings) == (bert["hidden"],
                                              bert["layers"], 30522, 512)
    _equal_state(engine.model, written, "engine weights vs written")
    cache = models / "asr" / "torch_converted"
    assert (cache / "params.pt").exists() and (cache / "metadata.json").exists()
    t0 = time.perf_counter()
    with _no_reconversion():
        cfg, sd, vocab = load_or_convert_w2v_bert(models / "asr")
    restore_s = time.perf_counter() - t0
    assert cfg == engine.model_cfg and vocab == engine.vocab.vocab
    assert set(sd) == set(written) and all(
        torch.equal(sd[k], t) for k, t in written.items())
    log(f"[production] second load restored torch_converted/ bit-equal in "
        f"{restore_s:.2f} s")
    del sd
    t0 = time.perf_counter()
    TextSentimentAnalyzer(PipelineConfig.from_dict({
        "client_text_model_path": str(models / "client_text"),
        "agent_text_model_path": str(models / "agent_text")}), DEVICE)
    torch.cuda.synchronize()
    text_load_s = time.perf_counter() - t0
    log(f"[production] load times: setup_models {res['setup_s']:.2f} s "
        f"(checkpoint convert + cache write + both text classifiers), "
        f"cache restore {restore_s:.2f} s, both text classifiers "
        f"{text_load_s:.2f} s")
    # The text classifier's cost at the shapes the run gave it, and at
    # B = 16 at every length bucket.
    text = res["text"]
    shapes = sorted(set(text.shapes_run)
                    | {(16, L) for L in text._LEN_BUCKETS})
    ms = _time_text(text, "client", shapes)
    text_ms = sum(ms[s] * n for s, n in text.shapes_run.items())
    for s in shapes:
        log(f"[production] text classifier (BERT-base, fp32) B={s[0]} "
            f"L={s[1]}: {ms[s]:.2f} ms per dispatch, run "
            f"{text.shapes_run.get(s, 0)} times")
    log(f"[production] text classifiers: ~{text_ms:.0f} ms of the "
        f"{res['wall_s'] * 1e3:.0f} ms run "
        f"({text_ms / (res['wall_s'] * 1e3):.3f}), device time at these "
        "shapes")
    res.update({"text_ms": ms, "restore_s": restore_s,
                "text_load_s": text_load_s, "models": models})
    return res


def text_card_vs_cpu(models: Path, rows: list) -> None:
    """Phase 7b: the text analyzer on the card against the CPU, a small
    BERT directory and the BERT-base one, on 16 texts."""
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.pipeline.sentiment import (
        TextSentimentAnalyzer,
    )

    texts = [r["client_transcription"] for r in rows][:12] + [
        "السلام عليكم، كيف داير؟", "salam labas 3lik", "wakha a sidi",
        "شكرا بزاف"]
    assert len(texts) == 16
    for name in ("small_text", "client_text"):
        cfg = PipelineConfig.from_dict({
            "client_text_model_path": str(models / name),
            "agent_text_model_path": str(models / name)})
        gpu = TextSentimentAnalyzer(cfg, DEVICE)
        cpu = TextSentimentAnalyzer(cfg, "cpu")
        tok_g = gpu.models["client"]["tokenizer"](texts)["input_ids"]
        tok_c = cpu.models["client"]["tokenizer"](texts)["input_ids"]
        assert np.array_equal(tok_g, tok_c) and np.array_equal(
            tok_g, gpu.models["client"]["tokenizer"](texts)["input_ids"])
        g = gpu.analyze_batch_sentiment(texts, "client")
        c = cpu.analyze_batch_sentiment(texts, "client")
        worst, clear, same = 0.0, 0, True
        for a, b in zip(g, c):
            assert (a["prediction"] == "") == (b["prediction"] == "")
            if not b["probabilities"]:
                continue
            pa, pb = np.asarray(a["probabilities"]), np.asarray(
                b["probabilities"])
            worst = max(worst, float(np.abs(pa - pb).max()))
            top2 = np.sort(pb)[-2:]
            if top2[1] - top2[0] > TEXT_PROB_TOL:
                clear += 1
                same &= a["prediction"] == b["prediction"]
        log(f"[text card vs cpu] {name}: {len(texts)} texts, tokens "
            f"{tok_g.shape}, ids equal on both; probabilities max_abs "
            f"{worst:.2e} (tol {TEXT_PROB_TOL:g}); predictions equal on "
            f"{clear} clear texts: {same}")
        assert worst <= TEXT_PROB_TOL and same and clear > 0


def int8_phase(seed: int, work: Path, models: Path, bf16_engine) -> dict:
    """Phase 7c: int8 on a tiny engine (card vs CPU), then the production
    run with ``quantization: int8``, then one 48 x 1280 batch timed int8
    beside bf16."""
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.pipeline.chunker import Chunk, chunk_batch

    small_reference(seed, "auto", quantization="int8")
    res = production_run(models, work / "run7c", seed + 17, 2, 0,
                         "[int8 production]", quantization="int8")
    int8_engine = res["engine"]
    assert w2v.quantize_model(int8_engine.model) is int8_engine.model
    # One full batch, 16 chunks x 25 s (48 x 1280), in turns.
    zeros_rng = np.random.default_rng(seed + 1)
    big = [Chunk("t.wav", i, 0.0, 25.0,
                 agent=(0.1 * zeros_rng.standard_normal(400000)).astype(
                     np.float32),
                 client=(0.1 * zeros_rng.standard_normal(400000)).astype(
                     np.float32)) for i in range(16)]
    (bb,) = chunk_batch(big, bf16_engine.bucket_samples)
    bbuf, blen = bf16_engine._prepare_fused_buffer(bb, 16)
    walls = {"bf16": [], "int8": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        eng = bf16_engine if name == "bf16" else int8_engine
        ub, ul = eng._upload(bbuf), eng._upload(blen)
        eng._fused(ub, ul, bb.bucket_len)
        torch.cuda.synchronize()
        for _ in range(3):
            t0 = time.perf_counter()
            eng._fused(ub, ul, bb.bucket_len)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    log(f"[int8] card: {smi_line()}")
    log(f"[int8] wall per 48 x 1280 batch (host clock, in turns bf16, int8, "
        f"int8, bf16): bf16 {[round(w, 4) for w in walls['bf16']]} s, int8 "
        f"{[round(w, 4) for w in walls['int8']]} s; best bf16 "
        f"{min(walls['bf16']):.4f} s, int8 {min(walls['int8']):.4f} s")
    return {"walls": walls, "launches": res["launches"]}


# ---------------------------------------------------------- phases 4c, 8
def _clear_ids(cpu, rows, lengths, ids_c, ids_g, n_real, label):
    """Greedy ids card vs CPU on the real rows' frames whose CPU top-2
    margin exceeds MARGIN; returns (clear, total) frame counts."""
    from audio_processor_tpu_torch.dsp.fbank import log_mel_frontend
    from audio_processor_tpu_torch.pipeline.asr_engine import pad_seq

    feats, mask = pad_seq(*log_mel_frontend(rows, lengths))
    with torch.inference_mode():
        logits = cpu.model(feats, mask, attention_impl=cpu.attention_impl)
    top2 = logits.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) > MARGIN)[:n_real] \
        & mask[:n_real]
    same = torch.equal(ids_c[:n_real][clear], ids_g[:n_real][clear])
    if not (same and int(clear.sum()) > 0):
        raise AssertionError(f"card and CPU ids differ: {label}")
    return int(clear.sum()), int(mask[:n_real].sum())


def message_reference(seed: int, impl: str, profile: bool) -> None:
    """Phase 4c: the message path's parts on the card against the CPU,
    fp32, same weights and audio; ``impl`` as in :func:`small_reference`.
    ``profile``: also run one mono dispatch under ``enable_profiling``."""
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.io.decode import load_audio
    from audio_processor_tpu_torch.models import vad
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.models.ctc_beam import ctc_beam_search
    from audio_processor_tpu_torch.models.tokenizer import CTCVocab
    from audio_processor_tpu_torch.obs.profiler import maybe_trace
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
    from audio_processor_tpu_torch.pipeline.chunker import (
        Chunk, chunk_batch, split_audio,
    )

    tag = f"[message reference {impl}]"
    with tempfile.TemporaryDirectory() as tmp:
        _write_calls(Path(tmp) / "in", seed + 4, 1, 23.0, 0)
        wave, sr = load_audio(Path(tmp) / "in" / "call-00.wav")
    # PyanNet, windowed, from a pyannote-layout state dict.
    vcfg = vad.PyanNetConfig(num_outputs=3)
    sd = vad.convert_pyannet(vad.synthetic_pyannote_state_dict(seed + 4),
                              vcfg)
    probs = {}
    for dev in ("cpu", "cuda"):
        model = vad.PyanNet(vcfg)
        model.load_state_dict(sd)
        probs[dev] = vad.pyannet_probs_windowed(model.to(dev).eval(),
                                                wave[0])
    dv = float(np.abs(probs["cuda"] - probs["cpu"]).max())
    x = torch.from_numpy(np.ascontiguousarray(wave))
    lengths = torch.tensor([wave.shape[1], wave.shape[1] - 12345])
    (ep_c, em_c), (ep_g, em_g) = (
        (t.cpu() for t in vad.energy_vad_probs(x.to(d), lengths.to(d)))
        for d in ("cpu", "cuda"))
    de = float((ep_g - ep_c).abs().max())
    log(f"{tag} PyanNet windowed probs ({probs['cpu'].shape[0]} frames of "
        f"23 s): max_abs {dv:.3e}; energy VAD probs max_abs {de:.3e}, masks "
        f"equal {torch.equal(em_c, em_g)} (tol {VAD_TOL:g})")
    assert dv <= VAD_TOL and de <= VAD_TOL and torch.equal(em_c, em_g)

    vocab = CTCVocab.darija_default()
    mcfg = w2v.W2VBertConfig(vocab_size=len(vocab), hidden_size=128,
                             num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=256)
    base = {"enable_mixed_precision": False, "chunk_duration_sec": 10.0,
            "overlap_sec": 1.0, "length_buckets_sec": [5.0, 10.0],
            "chunk_batch_size": 4, "attention_impl": impl}

    def pair(**extra):
        cfg = PipelineConfig.from_dict({**base, **extra})
        return tuple(ASREngine(cfg, device=d, model=w2v.build_synthetic(
            mcfg, torch.device("cpu"), seed=seed), vocab=vocab)
            for d in ("cpu", "cuda"))

    # VAD-like segments of the call, 3 to 9.5 s, both channels, padded
    # to each bucket's row tail.
    waves = [wave[i % 2, int(s * sr):int((s + d) * sr)] for i, (s, d) in
             enumerate(((0.0, 3.0), (2.5, 9.5), (11.0, 4.2), (15.0, 7.7),
                        (1.0, 5.0)))]

    def mono_rows(engine):
        chunks = [Chunk("", i, 0.0, 0.0, mixed=w)
                  for i, w in enumerate(waves)]
        for batch in chunk_batch(chunks, engine.bucket_samples):
            n_dev = engine._row_tail_size(len(batch))
            rows = np.zeros((n_dev, batch.bucket_len), np.float32)
            lens = np.full(n_dev, batch.bucket_len, np.int32)
            rows[:len(batch)] = batch.audio[:, 0]
            lens[:len(batch)] = batch.lengths
            yield batch, torch.from_numpy(rows), torch.from_numpy(lens)

    cpu, gpu = pair()
    for batch, r, ln in mono_rows(cpu):
        ids_c, mask_c = cpu._mono(r, ln, beam=False)
        ids_g, mask_g = (t.cpu() for t in gpu._mono(r.cuda(), ln.cuda(),
                                                    beam=False))
        assert torch.equal(mask_c, mask_g), "masks differ"
        n_clear, n_valid = _clear_ids(cpu, r, ln, ids_c, ids_g, len(batch),
                                      f"mono bucket {batch.bucket_len}")
        log(f"{tag} mono rows {tuple(r.shape)}: ids equal on "
            f"{n_clear}/{n_valid} clear valid frames, masks equal")

    # beam_width 4: the card's texts are ctc_beam_search of its own log
    # posteriors, which match the CPU's.
    cpu, gpu = pair(beam_width=4)
    texts = gpu.transcribe_mono_segments(waves)
    expect, worst = {}, 0.0
    for batch, r, ln in mono_rows(gpu):
        lp_g, m_g = (t.cpu() for t in gpu._mono(r.cuda(), ln.cuda(),
                                                beam=True))
        lp_c, m_c = cpu._mono(r, ln, beam=True)
        real = m_c[:len(batch)]
        worst = max(worst, float((lp_g[:len(batch)][real]
                                  - lp_c[:len(batch)][real]).abs().max()))
        for j, c in enumerate(batch.chunks):
            expect[c.chunk_idx] = ctc_beam_search(
                lp_g[j].numpy(), vocab, beam_width=4,
                mask=m_g[j].numpy())[0][0]
    same = texts == [expect[i] for i in range(len(waves))]
    log(f"{tag} beam_width 4: {len(texts)} texts equal ctc_beam_search of "
        f"the card's log posteriors: {same}; log posteriors card vs CPU "
        f"max_abs {worst:.3e} (tol {LOGP_TOL:g})")
    assert same and worst <= LOGP_TOL

    # fuse_acoustic_features: false, the three views through mono.
    cpu, gpu = pair(fuse_acoustic_features=False)
    for batch in chunk_batch(split_audio(wave, sr, "ref.wav", 10.0, 1.0),
                             cpu.bucket_samples):
        rows, lens = cpu._prepare_rows(batch)
        r, ln = torch.from_numpy(rows), torch.from_numpy(lens)
        ids_c, mask_c = cpu._mono(r, ln, beam=False)
        ids_g, mask_g = (t.cpu() for t in gpu._mono(r.cuda(), ln.cuda(),
                                                    beam=False))
        assert torch.equal(mask_c, mask_g), "masks differ"
        n_clear, n_valid = _clear_ids(cpu, r, ln, ids_c, ids_g,
                                      3 * len(batch), "unfused")
        log(f"{tag} unfused bucket {batch.bucket_len}, {len(batch)} "
            f"chunk(s): ids equal on {n_clear}/{n_valid} clear valid frames")

    if profile:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = PipelineConfig.from_dict({"enable_profiling": True,
                                            "output_folder": tmp})
            with maybe_trace(cfg):
                gpu._mono(r.cuda(), ln.cuda(), beam=False)
                torch.cuda.synchronize()
            (trace,) = (Path(tmp) / "profile").glob("trace_*.json")
            events = json.loads(trace.read_text())["traceEvents"]
        kernels = sorted({e["name"] for e in events
                          if e.get("cat") == "kernel"})
        named = [k for k in kernels if "flash_rel_kernel" in k]
        log(f"{tag} enable_profiling: {trace.name}, {len(events)} events, "
            f"{len(kernels)} kernel names, flash-rel kernel: {named[:1]}")
        assert named, kernels[:20]


def message_path(seed: int, work: Path, n_calls: int = 4,
                 n_8k: int = 1) -> dict:
    """Phase 8: the message path at full width through DataProcessor;
    launch counts set to 0 just before the run (every shape warmed
    before, so the run's own dispatches are what it counts)."""
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.dsp.fbank import max_num_frames
    from audio_processor_tpu_torch.host.db import DatabaseManager
    from audio_processor_tpu_torch.io.decode import load_audio
    from audio_processor_tpu_torch.models.vad import (
        synthetic_pyannote_state_dict,
    )
    from audio_processor_tpu_torch.models.wav2vec2bert import W2VBertConfig
    from audio_processor_tpu_torch.pipeline.engine import DataProcessor
    from audio_processor_tpu_torch.pipeline.segmenter import (
        SpeechBatchTranscriber,
    )

    tag = "[message]"
    log(f"{tag} card: {smi_line()}")
    ckpt = work / "pyannet.ckpt"
    work.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": synthetic_pyannote_state_dict(seed + 8)},
               ckpt)
    audio_s = _write_calls(work / "input", seed + 8, n_calls, 100.0, n_8k)
    cfg = PipelineConfig.from_dict({
        "input_folder": str(work / "input"),
        "output_folder": str(work / "output"),
        "logs_folder": str(work / "logs"), "temp_dir": str(work / "tmp"),
        "database_type": "sqlite", "db_path": str(work / "messages.db"),
        "chunk_batch_size": 16, "enable_mixed_precision": True,
        "enable_message_path": True, "vad_model_id": str(ckpt)})
    db = DatabaseManager(cfg)
    proc = DataProcessor(cfg, db_manager=db, device=DEVICE)
    try:
        proc.setup_models()
        engine = proc.asr_engine
        mcfg = engine.model_cfg
        assert mcfg == W2VBertConfig(vocab_size=mcfg.vocab_size)
        assert engine.attention_impl == "flash_rel"
        assert engine.dtype == torch.bfloat16
        proc._transcriber = SpeechBatchTranscriber(cfg, asr_engine=engine)
        seg = proc._transcriber.segmenter
        assert seg._vad_params is not None, "PyanNet did not load"
        assert seg.device.type == "cuda"
        t0 = time.perf_counter()
        warmed = engine.warmup(message_rows=True)
        torch.cuda.synchronize()
        log(f"{tag} warmup: {warmed} shapes in "
            f"{time.perf_counter() - t0:.2f} s (outside the counted run)")

        # VAD alone on one 100 s channel (16 kHz), host clock around a
        # dispatch + fetch (the fetch syncs), after one warm call.
        wave, sr = load_audio(work / "input" / "call-00.wav")
        seg.vad_probs(wave[0], sr)
        vad_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            seg.vad_probs(wave[0], sr)
            vad_ms.append((time.perf_counter() - t0) * 1e3)

        # The run: time the VAD and the mono transcription inside it, and
        # keep the per-channel VAD results.
        spent = {"vad": 0.0, "asr": 0.0}
        per_channel = []
        real_multi = seg.get_speech_segments_multi
        real_tr = seg.transcribe_segments_batched

        def multi(channels, rate):
            t = time.perf_counter()
            out = real_multi(channels, rate)
            spent["vad"] += time.perf_counter() - t
            per_channel.extend(out)
            return out

        def transcribe(segments, rate):
            t = time.perf_counter()
            out = real_tr(segments, rate)
            spent["asr"] += time.perf_counter() - t
            return out

        seg.get_speech_segments_multi = multi
        seg.transcribe_segments_batched = transcribe
        _reset_launches()
        engine.dispatches = engine.mono_dispatches = 0
        engine.mono_shapes.clear()
        t0 = time.perf_counter()
        succeeded = proc.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = _launches()
        stats = dict(proc.stats)
        hit = dict(engine.mono_shapes)
        dispatches = (engine.dispatches, engine.mono_dispatches)

        # mono-ASR ms per dispatch at every (rows, bucket) the program
        # serves, by CUDA events on zero-padded noise rows.
        rng = np.random.default_rng(seed)
        mono_ms = {}
        for bucket in engine.bucket_samples:
            for rows_n in (12, 24, 48):
                r = torch.from_numpy((0.1 * rng.standard_normal(
                    (rows_n, bucket))).astype(np.float32)).cuda()
                ln = torch.full((rows_n,), bucket, dtype=torch.int32,
                                device="cuda")
                mono_ms[(rows_n, bucket)] = _cuda_ms(
                    lambda: engine._mono(r, ln, beam=False), 3)
        messages = {f"call-{i:02d}": db.get_messages_by_id_enregistrement(
            f"call-{i:02d}") for i in range(n_calls)}
    finally:
        proc.close()
        db.close()

    layers = mcfg.num_hidden_layers
    launches = counts["flash_rel_attention"]
    n_seg = sum(len(c) for c in per_channel if c)
    frames = sorted((rows, -(-max_num_frames(b) // 2 // 256) * 256)
                    for rows, b in hit)
    log(f"{tag} files succeeded {succeeded}/{n_calls}, errors "
        f"{stats['errors']}; VAD channels {len(per_channel)} (failed "
        f"{sum(c is None for c in per_channel)}), segments {n_seg}, message "
        f"rows {sum(len(m) for m in messages.values())}")
    log(f"{tag} dispatches: fused {dispatches[0]}, mono {dispatches[1]} at "
        f"(rows, bucket samples) {hit}; flash_rel launches {launches} = "
        f"{layers} x {sum(dispatches)}: "
        f"{launches == layers * sum(dispatches)}; all counts {counts}")
    log(f"{tag} VAD (PyanNet, fp32) per 100 s channel: "
        f"{[round(v, 2) for v in vad_ms]} ms (host clock, fetch included)")
    for (rows_n, bucket), ms in sorted(mono_ms.items()):
        log(f"{tag} mono-ASR (w2v-bert-2.0, bf16) rows {rows_n} x bucket "
            f"{bucket / 16000:.0f} s: {ms:.2f} ms per dispatch"
            f"{'  (hit by the run ' + str(hit[(rows_n, bucket)]) + 'x)' if (rows_n, bucket) in hit else ''}")
    log(f"{tag} in the run: VAD {spent['vad']:.3f} s, mono ASR "
        f"{spent['asr']:.3f} s (VAD share of the two "
        f"{spent['vad'] / max(spent['vad'] + spent['asr'], 1e-9):.3f}); "
        f"wall {wall_s:.2f} s for {audio_s:.0f} s of audio: RTFx "
        f"{audio_s / wall_s:.1f}")
    assert succeeded == n_calls and stats["files_success"] == n_calls, stats
    assert stats["errors"] == 0, stats
    assert len(per_channel) == 2 * n_calls and all(
        c is not None for c in per_channel), "a VAD channel failed"
    for stem, rows in messages.items():
        assert rows, f"{stem}: no message rows"
        assert [m["order_message"] for m in rows] == list(
            range(1, len(rows) + 1)), stem
        assert {m["speaker"] for m in rows} <= {"agent", "client"}, stem
    assert set(frames) <= set(MESSAGE_SHAPES), frames
    assert launches > 0 and launches == layers * sum(dispatches), counts
    assert counts["add_layer_norm"] == 6 * launches, counts
    assert all(n == 0 for k, n in counts.items()
               if k not in ("flash_rel_attention", "add_layer_norm")), counts
    return {"launches": launches, "vad_ms": vad_ms, "mono_ms": mono_ms,
            "wall_s": wall_s, "segments": n_seg}


# ---------------------------------------------------------- phases 4d, 9
def _load_tool(name: str):
    """A script of ``tools/`` as a module (its ``main`` does not run)."""
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _near_tie_texts(engine, logits, mask, most: int = 10):
    """Every text the engine's decode gives one row of logits [L', V]
    when each valid frame whose top-2 margin is at most MARGIN takes
    either of its two top tokens (one text when there is none); None
    past ``most`` such frames."""
    import itertools

    from audio_processor_tpu_torch.models.tokenizer import batch_decode
    from audio_processor_tpu_torch.utils.text import remove_special_characters

    top = logits.topk(2, dim=-1)
    near = torch.nonzero(mask & ((top.values[:, 0] - top.values[:, 1])
                                 <= MARGIN)).flatten().tolist()
    if len(near) > most:
        return None
    pad = engine.model_cfg.pad_token_id
    texts = set()
    for pick in itertools.product((0, 1), repeat=len(near)):
        ids = top.indices[:, 0].clone()
        for f, k in zip(near, pick):
            ids[f] = top.indices[f, k]
        ids = torch.where(mask, ids, torch.full_like(ids, pad))
        texts.add(remove_special_characters(batch_decode(
            ids[None].numpy(), engine.vocab, mask[None].numpy())[0]))
    return texts


def serving_reference(seed: int) -> None:
    """Phase 4d: one tiny fp32 engine's weights in two InferenceServices,
    one on the card and one on the CPU; the same 6 WAV bodies (2 to 9 s,
    one at 8 kHz) go to both services at once. Each response's chunks
    (count, index, times, order) must be equal on both; each chunk view's
    transcript must be equal where the CPU engine's top-2 margin exceeds
    MARGIN on every valid frame, and elsewhere both transcripts must be
    among those the near-tie frames' two top tokens can give."""
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.io.decode import load_audio_bytes
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.models.tokenizer import CTCVocab
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
    from audio_processor_tpu_torch.pipeline.chunker import (
        chunk_batch, prepare_and_split,
    )
    from audio_processor_tpu_torch.serving import InferenceService

    lt = _load_tool("load_test_serving_torch")
    tag = "[serve reference]"
    cfg = PipelineConfig.from_dict({
        "enable_mixed_precision": False, "chunk_duration_sec": 4.0,
        "overlap_sec": 1.0, "length_buckets_sec": [2.0, 4.0],
        "chunk_batch_size": 4, "serve_batch_window_ms": 30.0})
    vocab = CTCVocab.darija_default()
    mcfg = w2v.W2VBertConfig(vocab_size=len(vocab), hidden_size=128,
                             num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=256)
    services = {d: InferenceService(cfg, asr_engine=ASREngine(
        cfg, device=d, model=w2v.build_synthetic(mcfg, torch.device("cpu"),
                                                 seed=seed), vocab=vocab))
        for d in ("cpu", DEVICE)}
    durs = (2.0, 3.5, 5.0, 6.5, 8.0, 9.0)
    bodies = [lt.wav_bytes(lt.call_pcm(d, seed + 40 + k, 8000 if k == 2
                                       else 16000), 8000 if k == 2 else 16000)
              for k, d in enumerate(durs)]
    outs = {d: [None] * len(bodies) for d in services}

    def one(dev, k):
        outs[dev][k] = services[dev].transcribe_bytes(bodies[k])

    threads = [threading.Thread(target=one, args=(d, k))
               for d in services for k in range(len(bodies))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads), "a request hung"
        cpu = services["cpu"].engine
        views = clear = explained = unchecked = differ = 0
        for k, body in enumerate(bodies):
            card, ref = outs[DEVICE][k], outs["cpu"][k]
            assert card["num_chunks"] == ref["num_chunks"] >= 1
            assert [(c["chunk_idx"], c["start_time"], c["end_time"])
                    for c in card["chunks"]] == [
                (c["chunk_idx"], c["start_time"], c["end_time"])
                for c in ref["chunks"]], k
            assert abs(card["duration_seconds"] - durs[k]) < 1e-3
            wave, sr = load_audio_bytes(body)
            _, _, chunks = prepare_and_split(wave, sr, "request.wav", cfg)
            for batch in chunk_batch(chunks, cpu.bucket_samples):
                buf, lengths = cpu._prepare_fused_buffer(
                    batch, cpu._tail_size(len(batch)))
                feats, mask = _fused_features(buf, lengths, batch.bucket_len)
                with torch.inference_mode():
                    logits = cpu.model(feats, mask,
                                       attention_impl=cpu.attention_impl)
                for j, c in enumerate(batch.chunks):
                    for v, key in enumerate(("transcription_chunk",
                                             "agent_transcription",
                                             "client_transcription")):
                        a = card["chunks"][c.chunk_idx][key]
                        b = ref["chunks"][c.chunk_idx][key]
                        texts = _near_tie_texts(cpu, logits[3 * j + v],
                                                mask[3 * j + v])
                        views += 1
                        differ += a != b
                        if texts is None:
                            unchecked += 1
                        elif len(texts) == 1:
                            clear += 1
                            assert a == b == next(iter(texts)), (k, j, key)
                        else:
                            explained += 1
                            assert a in texts and b in texts, (k, j, key)
    finally:
        for svc in services.values():
            svc.close(drain_timeout=30)
    n_chunks = sum(o["num_chunks"] for o in outs[DEVICE])
    log(f"{tag} 6 bodies ({', '.join(f'{d:g}' for d in durs)} s; the "
        f"5 s one at 8 kHz) to the card's and the CPU's service at once: "
        f"{n_chunks} chunks, times and order equal; of {views} chunk "
        f"views, {clear} with no near-tie frame (transcripts equal), "
        f"{explained} with near ties (both transcripts among their top-2 "
        f"choices), {unchecked} with more than 10 near ties; transcripts "
        f"differ on {differ}")
    assert unchecked <= views // 10, (unchecked, views)
    assert all(svc.stats["batches"] < len(bodies)
               for svc in services.values()), "no micro-batching"


def _response_checks(out: dict, audio_s: float, openai: bool,
                     sentiment: bool) -> None:
    """One phase-9 response against its own audio: duration, chunk count
    and end times of a split of ``audio_s`` seconds (so no rows crossed
    between requests), and the text sentiment rule where it was asked."""
    from audio_processor_tpu_torch.pipeline.chunker import chunk_boundaries

    ends = [e / 16000 for _, e in chunk_boundaries(int(audio_s * 16000),
                                                   25 * 16000, 24 * 16000)]
    if openai:
        assert abs(out["duration"] - audio_s) < 1e-3, out["duration"]
        assert [s["end"] for s in out["segments"]] == ends, out["segments"]
        assert out["text"] == " ".join(s["text"]
                                       for s in out["segments"]).strip()
        return
    assert abs(out["duration_seconds"] - audio_s) < 1e-3
    assert out["num_chunks"] == len(ends)
    assert [c["end_time"] for c in out["chunks"]] == ends
    assert [c["chunk_idx"] for c in out["chunks"]] == list(range(len(ends)))
    for c in out["chunks"]:
        assert c["error"] == "", c["error"]
        for speaker, labels in (("agent", AGENT_LABELS),
                                ("client", CLIENT_LABELS)):
            if not sentiment:
                assert f"{speaker}_text_sentiment" not in c
                continue
            pred = c[f"{speaker}_text_sentiment"]
            text = c[f"{speaker}_transcription"]
            assert (pred != "") == (len(text.strip()) >= 5), (text, pred)
            assert pred == "" or pred in labels, pred


def serving_path(seed: int, models: Path, asr: dict = W2V_BERT_2,
                 bert: dict = BERT_BASE, clients: int = 8,
                 durs: tuple = (20.0, 60.0, 100.0)) -> dict:
    """Phase 9: the HTTP server at full width, from phase 7's HF
    directory (a cache restore) and both text classifiers; launch counts
    set to 0 after the warmup and read after the drain."""
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.pipeline.chunker import (
        StreamingChunker, chunk_boundaries,
    )
    from audio_processor_tpu_torch.pipeline.sentiment import (
        SentimentAnalyzer,
    )
    from audio_processor_tpu_torch.serving import serve
    from audio_processor_tpu_torch.utils.system import (
        check_device_availability, get_device_memory_usage,
    )

    lt = _load_tool("load_test_serving_torch")
    tag = "[serve]"
    log(f"{tag} card: {smi_line()}")
    cfg = PipelineConfig.from_dict({
        "transcription_model": str(models / "asr"),
        "client_text_model_path": str(models / "client_text"),
        "agent_text_model_path": str(models / "agent_text"),
        "chunk_batch_size": 16, "enable_mixed_precision": True,
        "serve_batch_window_ms": 20, "serve_warmup": True})
    t0 = time.perf_counter()
    with _no_reconversion():
        server = serve(cfg, host="127.0.0.1", port=0,
                       sentiment_analyzer=SentimentAnalyzer(cfg,
                                                            device=DEVICE))
    setup_s = time.perf_counter() - t0
    svc = server.service
    engine, text = svc.engine, svc.sentiment.text_analyzer
    mcfg = engine.model_cfg
    assert (mcfg.hidden_size, mcfg.num_hidden_layers,
            mcfg.num_attention_heads, mcfg.intermediate_size) == (
        asr["hidden"], asr["layers"], asr["heads"], asr["ffn"]), mcfg
    assert engine.device.type == torch.device(DEVICE).type
    assert engine.dtype == torch.bfloat16 and text.models_available
    assert text.models["client"]["cfg"].num_hidden_layers == bert["layers"]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    log(f"{tag} serve(): {setup_s:.2f} s (checkpoint restore, both text "
        f"classifiers, warmup {svc.warmup_seconds:.2f} s); attention "
        f"{engine.attention_impl}, batch window {svc.batch_window_ms:g} ms")
    try:
        _reset_launches()
        engine.dispatches = 0
        res = {"setup_s": setup_s, "warmup_s": svc.warmup_seconds}

        # Concurrent load: each client posts its calls back to back.
        jobs = {}
        for i in range(clients):
            sr = 8000 if i == clients - 1 else 16000
            for j, d in enumerate(durs):
                jobs[(i, j)] = {
                    "audio_s": d, "body": lt.wav_bytes(
                        lt.call_pcm(d, seed + 100 + 3 * i + j, sr), sr),
                    "sentiment": (i + j) % 2 == 1, "openai": i == 0}

        def client(i):
            for j in range(len(durs)):
                job = jobs[(i, j)]
                query = "?sentiment=1" if job["sentiment"] else ""
                if job["openai"]:
                    body, headers = lt.multipart({
                        "file": ("call.wav", job["body"]),
                        "response_format": (None, b"verbose_json")})
                    path = "/v1/audio/transcriptions" + query
                else:
                    body, headers, path = (job["body"], {},
                                           "/v1/transcribe" + query)
                job["status"], _, raw = lt.request(port, path, body, headers)
                job["out"] = json.loads(raw)

        before = lt.get_json(port, "/v1/stats")
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        load_s = time.perf_counter() - t0
        assert not any(t.is_alive() for t in threads), "a client hung"
        stats = lt.get_json(port, "/v1/stats")
        for key, job in jobs.items():
            assert job["status"] == 200, (key, job["status"], job["out"])
            _response_checks(job["out"], job["audio_s"], job["openai"],
                             job["sentiment"])
        n_req = stats["requests"] - before["requests"]
        batches = stats["batches"] - before["batches"]
        audio_s = sum(job["audio_s"] for job in jobs.values())
        n_sent = sum(job["sentiment"] for job in jobs.values())
        log(f"{tag} load: {clients} clients x {len(durs)} stereo PCM16 "
            f"calls ({', '.join(f'{d:g}' for d in durs)} s; one client at "
            f"8 kHz, one on /v1/audio/transcriptions verbose_json), "
            f"{n_sent} with sentiment: {n_req} requests, "
            f"{stats['chunks'] - before['chunks']} chunks, {audio_s:.0f} s "
            f"of audio in {load_s:.2f} s: serving RTFx "
            f"{audio_s / load_s:.1f}; all 200, durations, chunk counts and "
            f"end times each its own audio's; text predictions exactly on "
            f"transcripts of >= 5 characters")
        log(f"{tag} /v1/stats: p50 {stats['p50_latency_seconds']} s, p95 "
            f"{stats['p95_latency_seconds']} s, {batches} device batches "
            f"for {n_req} requests ({n_req / max(batches, 1):.2f} requests "
            f"per batch), batch errors {stats['batch_errors']}")
        assert n_req == len(jobs) and stats["batch_errors"] == 0, stats
        assert 0 < batches < n_req, (batches, n_req)
        res.update({"rtfx": audio_s / load_s, "load_s": load_s,
                    "p50": stats["p50_latency_seconds"],
                    "p95": stats["p95_latency_seconds"],
                    "requests_per_batch": n_req / batches})

        # Idle latency: one 20 s request alone, five times.
        idle_body = jobs[(1, 0)]["body"]
        idle = []
        for _ in range(5):
            t0 = time.perf_counter()
            status, _, _ = lt.request(port, "/v1/transcribe", idle_body)
            idle.append(time.perf_counter() - t0)
            assert status == 200
        res["idle_s"] = float(np.median(idle))
        log(f"{tag} idle latency of one {durs[0]:g} s request (client clock, "
            f"5 alone): {[round(x, 4) for x in idle]} s, median "
            f"{res['idle_s']:.4f} s")

        # Streaming: one 100 s call as 0.5 s int16 pieces.
        pcm = lt.call_pcm(durs[-1], seed + 200)
        pieces = [pcm[:, k:k + 8000] for k in range(0, pcm.shape[1], 8000)]
        try:
            import google.protobuf  # noqa: F401
            import grpc  # noqa: F401
            route = "grpc"
        except ImportError:
            route = "in-process"
        t0 = time.perf_counter()
        if route == "grpc":
            from audio_processor_tpu_torch.grpc_serving import (
                GrpcClient, GrpcInferenceServer,
            )

            gsrv = GrpcInferenceServer(svc, 0)
            gsrv.start()
            gclient = GrpcClient(f"127.0.0.1:{gsrv.bound_port}")
            try:
                streamed = [(c.start_time, c.end_time, c.transcription_chunk,
                             c.agent_transcription, c.client_transcription)
                            for c in gclient.streaming_transcribe(
                                pieces, channels=2, timeout=600.0)]
            finally:
                gclient.close()
                gsrv.stop()
        else:
            chunker = StreamingChunker(16000, "stream", 25.0, 1.0)
            streamed = []
            for piece in pieces + [None]:
                done = (chunker.flush() if piece is None else chunker.feed(
                    piece.astype(np.float32) / 32768.0))
                for chunk in done:
                    (row,) = svc.submit_chunks([chunk])
                    streamed.append((row["start_time"], row["end_time"],
                                     row["transcription_chunk"],
                                     row["agent_transcription"],
                                     row["client_transcription"]))
        stream_s = time.perf_counter() - t0
        status, _, raw = lt.request(port, "/v1/transcribe", lt.wav_bytes(pcm))
        assert status == 200
        unary = [(c["start_time"], c["end_time"], c["transcription_chunk"],
                  c["agent_transcription"], c["client_transcription"])
                 for c in json.loads(raw)["chunks"]]
        bounds = [(s / 16000, e / 16000) for s, e in chunk_boundaries(
            pcm.shape[1], 25 * 16000, 24 * 16000)]
        assert [r[:2] for r in streamed] == [r[:2] for r in unary] == bounds
        n_diff = sum(a[k] != b[k] for a, b in zip(streamed, unary)
                     for k in (2, 3, 4))
        log(f"{tag} streaming route: {route}")
        log(f"{tag} streaming: {durs[-1]:g} s call in {len(pieces)} pieces of "
            f"0.5 s -> {len(streamed)} chunks in {stream_s:.2f} s, boundaries "
            f"equal to split_audio's; transcripts differing from the unary "
            f"request's: {n_diff} of {3 * len(streamed)}")
        res.update({"stream_route": route, "stream_diff": n_diff})

        # Backpressure, then the drain.
        svc.max_pending_chunks = 2
        results = lt.burst(port, [jobs[(i, 1)]["body"]
                                  for i in range(1, 7)])
        svc.max_pending_chunks = 32 * svc.max_chunks
        n503, n200 = lt.check_burst(results)
        log(f"{tag} backpressure: 6 x {durs[1]:g} s at once against a "
            f"2-chunk cap: {n503} x 503 with Retry-After 5, {n200} x 200 "
            f"(a {durs[1]:g} s body is "
            f"{len(chunk_boundaries(int(durs[1] * 16000), 400000, 384000))}"
            f" chunks, over the cap alone)")
        in_flight = [jobs[(i, 2)]["body"] for i in range(1, 4)]
        n_chunks = 3 * len(chunk_boundaries(int(durs[2] * 16000), 400000,
                                            384000))
        drained = lt.drain(server, port, in_flight, n_chunks, idle_body)
        log(f"{tag} drain: close() with {drained['pending_at_close']} chunks "
            f"of 3 requests in flight: they finished "
            f"{drained['in_flight']}; a request during the close got "
            f"{drained['during_close']} ({drained['during_close_error']}); "
            f"close took {drained['close_s']:.2f} s")
        torch.cuda.synchronize()
        counts = _launches()
        dispatches = engine.dispatches

        ok, msg = check_device_availability()
        mem = get_device_memory_usage()
        log(f"{tag} probes: check_device_availability() = ({ok}, {msg!r}); "
            f"get_device_memory_usage() = {mem}")
        assert ok and isinstance(mem, float), (ok, mem)
        res["memory_pct"] = mem
    finally:
        server.shutdown()
        svc.close(drain_timeout=30)
        server.server_close()
    layers = mcfg.num_hidden_layers
    launches = counts["flash_rel_attention"]
    log(f"{tag} fused dispatches {dispatches} (warmup excluded); flash_rel "
        f"launches {launches} = {layers} x {dispatches}: "
        f"{launches == layers * dispatches}; all counts {counts}")
    log(f"{tag} summary: warmup {res['warmup_s']:.2f} s, serving RTFx "
        f"{res['rtfx']:.1f}, p50 {res['p50']} s, p95 {res['p95']} s, "
        f"{res['requests_per_batch']:.2f} requests per batch, idle "
        f"{durs[0]:g} s latency {res['idle_s']:.4f} s, device memory "
        f"{mem:.2f}%")
    assert launches > 0 and launches == layers * dispatches, counts
    assert counts["add_layer_norm"] == 6 * launches, counts
    assert all(n == 0 for k, n in counts.items()
               if k not in ("flash_rel_attention", "add_layer_norm")), counts
    res["launches"] = launches
    return res


# ---------------------------------------------------------- phases 4e, 10
TRAIN_LR = 1e-4        # phase 4e's learning rate (the CPU test's)
# Phase 4e, card vs CPU in fp32 (tests/test_torch_train_step.py's
# tolerances): losses 1e-5 relative; step-0 gradients within 1e-4 of
# their leaf's max |g| plus 1e-9 of the model's (linear_k.bias is zero
# in exact arithmetic and holds rounding noise); after 3 AdamW steps
# every param within lr and all but 0.1% within lr / 100 (Adam moves an
# element whose gradient sits at the noise floor by ~lr either way), the
# moments within 1e-4 of their leaf's max plus the gradient floor.
TRAIN_LOSS_RTOL, GRAD_LEAF_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-9
PARAM_TIGHT_SHARE, MOMENT_RTOL = 1e-3, 1e-4
BF16_LOSS_RTOL = 2e-2  # a bf16 step's loss against fp32's, per row too
# Phase 10's data: 16 training utterances of 5-25 s (one at 8 kHz) and 8
# eval ones (a full batch of FinetuneConfig's 8, so the eval loss is
# defined: the JAX package's evaluate averages full batches only).
FT_TRAIN, FT_EVAL = 16, 8


def _train_batch(seed: int, vocab_size: int) -> dict:
    """Phase 4e's batch on the CPU: 4 rows of 2 s (99 frames) of seeded
    features with ragged masks; labels ragged, with adjacent repeats, and
    row 3's cannot fit its frames (45 labels in 40 frames)."""
    rng = np.random.default_rng(seed)
    B, T, N = 4, 99, 45
    valid = np.array([99, 80, 61, 40])
    fmask = (np.arange(T)[None, :] < valid[:, None]).astype(np.float32)
    feats = rng.standard_normal((B, T, 160)).astype(np.float32) \
        * fmask[:, :, None]
    lens = np.array([30, 12, 5, 45])
    labels = rng.integers(5, vocab_size, (B, N))
    labels[1, 3] = labels[1, 2]
    labels[0, 7:10] = labels[0, 6]
    lmask = (np.arange(N)[None, :] < lens[:, None]).astype(np.float32)
    labels = labels * (lmask > 0)
    return {"features": torch.from_numpy(feats),
            "feature_mask": torch.from_numpy(fmask),
            "labels": torch.from_numpy(labels),
            "label_mask": torch.from_numpy(lmask)}


def train_reference(seed: int) -> None:
    """Phase 4e: the fine-tuning step on the card against the CPU, on a
    tiny model with the same weights on both (hidden 128, 2 heads of 64,
    2 layers, conv 7), fp32 with TF32 off, SpecAugment off, 3 AdamW
    steps each; one bf16 step on the card; the kernel wrapper's refusal
    of an operand that requires grad, on the card."""
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.models.flash_rel_attention import (
        flash_rel_attention,
    )
    from audio_processor_tpu_torch.models.tokenizer import CTCVocab
    from audio_processor_tpu_torch.training import train_step as ts

    assert not torch.backends.cuda.matmul.allow_tf32
    tag = "[train reference]"
    mcfg = w2v.W2VBertConfig(
        vocab_size=len(CTCVocab.darija_default()), hidden_size=128,
        num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
        conv_depthwise_kernel_size=7)
    cpu_batch = _train_batch(seed + 10, mcfg.vocab_size)

    def fresh(dev):
        model = w2v.build_synthetic(mcfg, torch.device("cpu"), seed=seed)
        return model.to(dev), {k: v.to(dev) for k, v in cpu_batch.items()}

    sides = {"cpu": "cpu", "card": "cuda"}
    states, batches, losses = {}, {}, {}
    for side, dev in sides.items():
        model, batches[side] = fresh(dev)
        states[side] = ts.init_state(model, ts.make_optimizer(TRAIN_LR))
        losses[side] = []
    for step in range(3):
        for side in sides:
            states[side], loss = ts.train_step(states[side], batches[side],
                                               dtype=torch.float32)
            losses[side].append(float(loss))
        if step == 0:
            grads = {side: {n: p.grad.detach().cpu() for n, p in
                            states[side].model.named_parameters()}
                     for side in sides}
    rel = [abs(g - c) / abs(c) for g, c in zip(losses["card"],
                                                losses["cpu"])]
    log(f"{tag} losses card {losses['card']} vs CPU {losses['cpu']}: max "
        f"rel {max(rel):.2e} (tol {TRAIN_LOSS_RTOL:g})")
    assert max(rel) <= TRAIN_LOSS_RTOL and losses["cpu"][0] > 1e4, rel
    gmax = max(float(g.abs().max()) for g in grads["cpu"].values())
    worst = 0.0
    for name, ref in grads["cpu"].items():
        got = grads["card"][name]
        assert torch.isfinite(got).all() and torch.isfinite(ref).all(), name
        tol = GRAD_LEAF_RTOL * float(ref.abs().max()) + GRAD_FLOOR * gmax
        worst = max(worst, float((got - ref).abs().max()) / tol)
    log(f"{tag} step-0 gradients: {len(grads['cpu'])} leaves, all finite, "
        f"worst err/tol {worst:.3f}")
    assert worst <= 1.0
    loose = total = 0
    cpu_p = dict(states["cpu"].model.named_parameters())
    for name, p in states["card"].model.named_parameters():
        d = (p.detach().cpu() - cpu_p[name].detach()).abs()
        assert float(d.max()) <= TRAIN_LR, name
        loose += int((d > TRAIN_LR / 100).sum())
        total += d.numel()
    mom = {side: ts.named_moments(states[side]) for side in sides}
    worst_m = 0.0
    for key, floor in (("exp_avg", GRAD_FLOOR * gmax),
                       ("exp_avg_sq", (GRAD_FLOOR * gmax) ** 2)):
        for name, ref in mom["cpu"][key].items():
            tol = MOMENT_RTOL * float(ref.abs().max()) + floor
            err = float((mom["card"][key][name].cpu() - ref).abs().max())
            worst_m = max(worst_m, err / tol)
    log(f"{tag} after 3 steps: params beyond lr/100 {loose}/{total} "
        f"(tol {PARAM_TIGHT_SHARE:g} of them), all within lr; moments "
        f"worst err/tol {worst_m:.3f}; Adam step {mom['card']['step']}")
    assert loose <= PARAM_TIGHT_SHARE * total and worst_m <= 1.0
    assert mom["card"]["step"] == mom["cpu"]["step"] == 3

    # One bf16 step on the card from the same weights: the loss, and each
    # row's, within 2e-2 relative of fp32's.
    model, batch = fresh("cuda")
    with torch.no_grad():
        feats, mask = batch["features"], batch["feature_mask"]
        rows = {dt: ts.ctc_loss(
            model(feats, mask.bool(), dtype=dt, attention_impl="xla"),
            1.0 - mask, batch["labels"], 1.0 - batch["label_mask"])
            for dt in (torch.float32, torch.bfloat16)}
    state = ts.init_state(model, ts.make_optimizer(TRAIN_LR))
    _, loss16 = ts.train_step(state, batch, dtype=torch.bfloat16)
    row_rel = ((rows[torch.bfloat16] - rows[torch.float32]).abs()
               / rows[torch.float32].abs()).max()
    rel16 = abs(float(loss16) - losses["card"][0]) / losses["card"][0]
    log(f"{tag} bf16 step loss {float(loss16):.4f} vs fp32 "
        f"{losses['card'][0]:.4f}: rel {rel16:.2e}, per row max rel "
        f"{float(row_rel):.2e} (tol {BF16_LOSS_RTOL:g})")
    assert rel16 <= BF16_LOSS_RTOL and float(row_rel) <= BF16_LOSS_RTOL

    # The kernel has no backward: an operand that requires grad is refused
    # on the card, before any launch.
    dev = torch.device("cuda")
    q, k, v = (torch.randn(1, 16, 256, 64, device=dev).bfloat16()
               for _ in range(3))
    E, kv = torch.randn(73, 64, device=dev), torch.ones(1, 256, device=dev)
    before = flash_rel_attention.launches
    try:
        flash_rel_attention(q.requires_grad_(), k, v, E, kv, 0.125, 64, 73)
    except RuntimeError as e:
        assert "no backward" in str(e), e
    else:
        raise AssertionError("flash_rel_attention ran under autograd")
    assert flash_rel_attention.launches == before
    log(f"{tag} flash_rel_attention refuses a requires_grad operand on the "
        "card: ok")


def _finetune_data(root: Path, seed: int, vocab) -> tuple:
    """Phase 10's manifests: FT_TRAIN training utterances of 5-25 s (the
    first 25 s, the last at 8 kHz) and FT_EVAL eval ones of 5-25 s, tone
    bursts over noise, with transcripts of ~2 words/s of the vocabulary's
    letters (~10 labels/s against 50 frames/s). Returns (train manifest,
    eval manifest, training audio s)."""
    from audio_processor_tpu_torch.io import wav

    rng = np.random.default_rng(seed)
    letters = [t for t in vocab.vocab if len(t) == 1
               and t != vocab.word_delimiter_token]
    root.mkdir(parents=True)
    paths, audio_s = [], 0.0
    for split, n in (("train", FT_TRAIN), ("eval", FT_EVAL)):
        rows = []
        for i in range(n):
            dur = 25.0 if (split, i) == ("train", 0) \
                else float(rng.uniform(5.0, 25.0))
            sr = 8000 if (split, i) == ("train", n - 1) else 16000
            t = np.arange(int(sr * dur)) / sr
            on = (np.floor(t / 0.3) % 2).astype(bool)
            x = 0.02 * rng.standard_normal(t.size) \
                + 0.3 * on * np.sin(2 * np.pi * rng.uniform(120, 300) * t)
            p = root / f"{split}-{i:02d}.wav"
            wav.write(p, x[None, :].astype(np.float32), sr)
            words = [
                "".join(rng.choice(letters, int(rng.integers(2, 7))))
                for _ in range(max(1, int(2 * dur)))]
            rows.append({"audio": str(p), "text": " ".join(words)})
            audio_s += dur if split == "train" else 0.0
        path = root / f"{split}.jsonl"
        path.write_text("\n".join(json.dumps(r, ensure_ascii=False)
                                  for r in rows))
        paths.append(path)
    return paths[0], paths[1], audio_s


def finetune_path(seed: int, work: Path, models: Path) -> dict:
    """Phase 10: CTC fine-tuning at full w2v-bert-2.0 width from phase
    7's HF directory (a ``torch_converted/`` restore), FinetuneConfig's
    defaults for batch (8) and length (25 s) with SpecAugment on, bf16:
    6 steps with a checkpoint and an eval every 3, then a resume that
    runs no step (params and moments bitwise), then a resume to 8 steps
    (steps 6 and 7 only). Launch counts set to 0 just before."""
    import dataclasses as dc

    from audio_processor_tpu_torch.dsp.fbank import max_num_frames
    from audio_processor_tpu_torch.models.tokenizer import CTCVocab
    from audio_processor_tpu_torch.training import finetune as ft
    from audio_processor_tpu_torch.training import train_step as ts

    tag = "[finetune]"
    log(f"{tag} card: {smi_line()}")
    train_m, eval_m, audio_s = _finetune_data(
        work / "data", seed + 10, CTCVocab.darija_default())
    out = work / "ckpt"
    cfg = ft.FinetuneConfig(
        manifest=str(train_m), eval_manifest=str(eval_m),
        output_dir=str(out), init_checkpoint=str(models / "asr"),
        num_steps=6, checkpoint_every=3, eval_every=3, seed=seed,
        device="cuda")
    assert (cfg.batch_size, cfg.max_audio_sec, cfg.spec_augment) == (
        8, 25.0, True)
    steps, final = [], {}

    def on_step(step, state, loss, times):
        steps.append({"step": step, "loss": float(loss), **times})
        if step == 0:
            bad = [n for n, p in state.model.named_parameters()
                   if not torch.isfinite(p.grad).all()]
            assert not bad, f"non-finite gradients at step 0: {bad[:5]}"
            for i, layer in enumerate(state.model.layers):
                att = layer.self_attn
                for name, p in (("linear_q", att.linear_q.weight),
                                ("linear_k", att.linear_k.weight),
                                ("linear_v", att.linear_v.weight),
                                ("distance_embedding",
                                 att.distance_embedding)):
                    assert float(p.grad.abs().max()) > 0, (i, name)
        if step == cfg.num_steps - 1:
            final["params"] = {n: p.detach().cpu().clone() for n, p in
                               state.model.named_parameters()}
            mom = ts.named_moments(state)
            final["moments"] = {k: {n: t.cpu().clone() for n, t in
                                    mom[k].items()}
                                for k in ("exp_avg", "exp_avg_sq")}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    model, losses = ft.finetune(cfg, on_step=on_step)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    mcfg = model.cfg
    assert (mcfg.hidden_size, mcfg.num_hidden_layers,
            mcfg.num_attention_heads, mcfg.intermediate_size) == (
        W2V_BERT_2["hidden"], W2V_BERT_2["layers"], W2V_BERT_2["heads"],
        W2V_BERT_2["ffn"]), mcfg
    n_params = sum(p.numel() for p in model.parameters())
    assert [s["step"] for s in steps] == list(range(6))
    assert all(np.isfinite(s["loss"]) for s in steps), steps
    meta = json.loads((out / "step_6" / "metadata.json").read_text())
    assert set(meta["eval"]) >= {"wer", "cer", "loss"}, meta.get("eval")
    assert np.isfinite(meta["eval"]["loss"]) and meta["step"] == 6
    assert (out / "step_3" / "params.pt").exists()
    del model

    # Resume with nothing left to run: bitwise params, then the moments
    # and step through load_train_state (timed, as is a save).
    model, losses2 = ft.finetune(dc.replace(cfg, resume=True))
    assert losses2 == []
    for n, p in model.named_parameters():
        assert torch.equal(p.detach().cpu(), final["params"][n]), n
    state = ts.init_state(model, ts.make_optimizer())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ft.load_train_state(state, out)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    mom = ts.named_moments(state)
    assert state.step == mom["step"] == 6
    for key, want in final["moments"].items():
        for n, t in want.items():
            assert torch.equal(mom[key][n].cpu(), t), (key, n)
    t0 = time.perf_counter()
    ft.save_train_state(state, out)
    save_s = time.perf_counter() - t0
    state_bytes = (out / "state_latest" / ft.STATE_FILE).stat().st_size
    del model, state, mom, final

    # Resume to 8 steps: steps 6 and 7 alone.
    more = []
    _, losses3 = ft.finetune(
        dc.replace(cfg, resume=True, num_steps=8),
        on_step=lambda step, state, loss, times: more.append(
            (step, state.step, float(loss))))
    assert [m[:2] for m in more] == [(6, 7), (7, 8)], more
    assert all(np.isfinite(m[2]) for m in more) and len(losses3) == 1
    counts = _launches()
    assert counts["flash_rel_attention"] == 0 \
        and counts["flash_attention"] == 0, counts

    timed = steps[1:]                       # step 0 pays first use
    med = {k: float(np.median([s[k] for s in timed]))
           for k in ("prep_s", "fwd_bwd_s", "opt_s")}
    wall = float(np.median([s["prep_s"] + s["fwd_bwd_s"] + s["opt_s"]
                            for s in timed]))
    frames = float(np.median([s["frames"] for s in timed]))
    padded = cfg.batch_size * (max_num_frames(
        int(cfg.max_audio_sec * cfg.sample_rate)) // 2)   # 8 x 1249
    total = torch.cuda.get_device_properties(0).total_memory
    flop_share = 6 * n_params * padded / wall / BF16_FLOPS
    log(f"{tag} w2v-bert-2.0 width ({n_params / 1e6:.1f} M params), batch "
        f"{cfg.batch_size} x 25 s ({padded} padded frames), bf16, remat, "
        f"SpecAugment; {audio_s:.1f} s of training audio in {FT_TRAIN} "
        f"utterances")
    log(f"{tag} losses by step {[round(s['loss'], 4) for s in steps]}, "
        f"then {[round(m[2], 4) for m in more]}; eval @6 {meta['eval']}")
    log(f"{tag} step wall, median of steps 1-5: {wall:.4f} s = prep "
        f"{med['prep_s']:.4f} + forward+backward {med['fwd_bwd_s']:.4f} + "
        f"optimizer {med['opt_s']:.4f} s; per step {steps}")
    log(f"{tag} training RTFx {frames * 0.02 / wall:.1f} (valid frames x "
        f"20 ms per wall s), {frames / wall:.0f} valid frames/s, "
        f"{padded / wall:.0f} padded frames/s; model FLOP share of bf16 "
        f"peak (6 N x padded frames / step / 989 TFLOP/s) "
        f"{flop_share:.4f}")
    log(f"{tag} peak memory {peak / 2**30:.2f} GiB = {peak / total:.4f} of "
        f"the card; state {state_bytes / 2**30:.2f} GiB, save "
        f"{save_s:.2f} s, restore {restore_s:.2f} s; first run (6 steps, "
        f"3 evals, 2 checkpoints) {run_s:.1f} s; launches {counts}")
    return {"launches": counts}


# ---------------------------------------------------------------- phase 11
# Phase 11d (fp32, TF32 off): the loss within 1e-4 relative of the
# one-process step; params within 1e-4 of their leaf's max |p| (at least
# 1e-4 absolute: the zero-initialised biases); AdamW at a learning rate of
# 1e-5, so that an element whose gradient sits at the noise floor, which
# Adam moves by up to lr either way, stays inside it; and each update
# (param after minus before) within lr / 100 of the one-process update on
# all but 0.1% of the elements. The pipelined forward within 1e-4.
SHARD_LOSS_RTOL, SHARD_PARAM_RTOL, SHARD_LR = 1e-4, 1e-4, 1e-5
DDP_LOSS_RTOL = 2e-3   # phase 11c, bf16: losses against one process
# Phase 11c, bf16: the consolidated moments against one process's, as
# ||got - want|| / ||want||, over all parameters and per parameter whose
# moment's rms is at least DDP_MOMENT_LEAF of the largest (below it sit
# gradients that are zero in exact arithmetic, e.g. key biases).
DDP_MOMENT_RTOL, DDP_MOMENT_LEAF = 5e-2, 1e-2
RESAMPLE_ATOL = 1e-5   # phase 11f, against resample_np (float64 sums)
# Phase 11d's shapes: the full width at 4 layers, 4 rows of 256 frames.
SHARD_LAYERS, SHARD_B, SHARD_T, SHARD_N = 4, 4, 256, 20


def _backend(world: int) -> str:
    """NCCL when each rank has a card; gloo, named here, where they
    share one (NCCL refuses two ranks on one device)."""
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def _ranks(phase: str, work: Path, world: int = 2,
           timeout_s: float = 300.0, **extra) -> list:
    """Run ``phase``'s rank worker in ``world`` processes of this script
    and return each rank's JSON result. Every rank is killed if the group
    fails or overruns."""
    from audio_processor_tpu_torch.parallel import launch

    work.mkdir(parents=True, exist_ok=True)
    init = launch.file_init_method(work)
    spec = json.dumps({"init": init, "work": str(work), **extra})
    t0 = time.perf_counter()
    outs = launch.run_ranks(
        lambda r: [sys.executable, str(Path(__file__).resolve()),
                   "--rank-worker", phase, "--rank", str(r), "--world",
                   str(world), "--spec", spec], world, timeout_s,
        cwd=str(REPO))
    wall = time.perf_counter() - t0
    for r, out in enumerate(outs):
        for line in out.strip().splitlines()[-6:]:
            log(f"  [rank {r}] {line}")
    res = [json.loads((work / f"rank{r}.json").read_text())
           for r in range(world)]
    for r in res:
        r["launch_wall_s"] = wall
    return res


def _join(spec: dict, rank: int, world: int) -> torch.device:
    from audio_processor_tpu_torch.parallel.distributed import (
        initialize_distributed, local_device,
    )

    initialize_distributed(spec["init"], num_processes=world,
                           process_id=rank, backend=_backend(world),
                           timeout_s=600)
    dev = local_device("cuda")
    torch.cuda.set_device(dev)
    return dev


class _IdSpy:
    """The greedy ids of each (file, chunk, view)'s valid frames and
    whether each frame's top-2 logit margin exceeds MARGIN, from the
    engine's own dispatches: a forward hook on each replica keeps the
    margins on the device, and the engine's fetch pairs them with the
    rows it decodes (warmup rows dropped)."""

    def __init__(self, engine):
        import collections

        self.margins = collections.deque()
        self.rows = {}
        for m in engine.replicas:
            m.register_forward_hook(self._hook)
        real = engine._fetch_pending

        def fetch(chunks, pending, results, done=None):
            # The engine enqueued these outputs on a stream of its own,
            # and this reads them before its fetch waits on their events.
            torch.cuda.synchronize()
            for sub_chunks, out, err in pending:
                if err is not None:
                    continue
                parts = out if isinstance(out, list) else [out]
                ids = torch.cat([p[0].cpu() for p in parts]).numpy()
                mask = torch.cat([p[1].cpu() for p in parts]).numpy()
                clear = torch.cat([self.margins.popleft().cpu()
                                   for _ in parts]).numpy()
                for j, c in enumerate(sub_chunks):
                    if c.file_name == "warmup.wav":
                        continue
                    for v in range(3):
                        ok = mask[3 * j + v].astype(bool)
                        self.rows[f"{c.file_name}|{c.chunk_idx}|{v}"] = (
                            ids[3 * j + v][ok], clear[3 * j + v][ok])
            return real(chunks, pending, results, done)

        engine._fetch_pending = fetch

    def _hook(self, module, args, output):
        top2 = output.topk(2, dim=-1).values
        self.margins.append((top2[..., 0] - top2[..., 1]) > MARGIN)

    def save(self, path: Path) -> None:
        np.savez(path, **{f"{k}|ids": v[0] for k, v in self.rows.items()},
                 **{f"{k}|clear": v[1] for k, v in self.rows.items()})


def _untimed_ids(proc, files) -> _IdSpy:
    """The ids and clear frames of ``files``' chunks, from one more pass
    of the processor's engine after its timed run: the spy's hook and
    its copies to the host stay out of the timed wall. Chunked as the
    processor chunks (``prepare_and_split``), one call to the engine."""
    from audio_processor_tpu_torch.io.decode import load_audio
    from audio_processor_tpu_torch.pipeline.chunker import prepare_and_split

    spy = _IdSpy(proc.asr_engine)
    chunks = []
    for f in sorted(files):
        wave, sr = load_audio(f)
        chunks += prepare_and_split(wave, sr, f.name, proc.config)[2]
    proc.asr_engine.transcribe_chunks(chunks)
    return spy


def _load_rows(path: Path) -> dict:
    with np.load(path) as z:
        keys = {k.rsplit("|", 1)[0] for k in z.files}
        return {k: (z[f"{k}|ids"], z[f"{k}|clear"]) for k in keys}


def _compare_ids(got: dict, want: dict, tag: str) -> tuple:
    """Ids equal on every frame clear in both runs; the row sets equal.
    Returns (clear frames compared, frames)."""
    assert set(got) == set(want), (tag, sorted(set(got) ^ set(want))[:6])
    n_clear = n = 0
    for key, (ids, clear) in want.items():
        ids2, clear2 = got[key]
        assert ids.shape == ids2.shape, (tag, key)
        both = clear & clear2
        bad = int((ids[both] != ids2[both]).sum())
        assert bad == 0, f"{tag} {key}: {bad} clear frames differ"
        n_clear += int(both.sum())
        n += ids.size
    return n_clear, n


def _batch_config(root: Path, out: str) -> dict:
    """Phase 5's configuration."""
    return {"input_folder": str(root / "input"),
            "output_folder": str(root / out),
            "logs_folder": str(root / "logs"),
            "temp_dir": str(root / f"tmp_{out}"),
            "chunk_batch_size": 16, "enable_mixed_precision": True,
            "save_csv_results": True}


def _worker_11a(spec: dict, rank: int, world: int) -> dict:
    """One process of 11a: DataProcessor.run over the calls it owns."""
    import torch.distributed as dist

    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.parallel.distributed import owns_call
    from audio_processor_tpu_torch.pipeline.engine import DataProcessor

    dev = _join(spec, rank, world)
    root = Path(spec["work"])
    proc = DataProcessor(PipelineConfig.from_dict(
        _batch_config(root, f"out_{rank}")), device=dev)
    try:
        proc.setup_models()
        _reset_launches()
        proc.asr_engine.dispatches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = proc.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = dict(proc.stats)
        dispatches, launches = proc.asr_engine.dispatches, _launches()
        _untimed_ids(proc, [f for f in (root / "input").glob("*.wav")
                            if owns_call(f.stem)]
                     ).save(root / f"ids_{rank}.npz")
    finally:
        proc.close()
    marks = sorted(p.stem for p in (root / f"out_{rank}" /
                                    "processed_markers").glob("*.done"))
    return {"backend": dist.get_backend(), "device": str(dev),
            "succeeded": n, "errors": stats["errors"], "markers": marks,
            "dispatches": dispatches, "launches": launches, "wall_s": wall}


def multi_process_batch(seed: int, work: Path, phase5: dict) -> dict:
    """11a: phase 5's 8 calls through ``DataProcessor.run`` in 2
    processes (each one owns its calls by call-id hash)."""
    import zlib

    tag = "[11a multi-process]"
    audio_s = _write_calls(work / "input", seed, 8, 100.0, 3)
    res = _ranks("11a", work)
    stems = [f"call-{i:02d}" for i in range(8)]
    shares = [set(r["markers"]) for r in res]
    for r, share in enumerate(shares):
        want = {s for s in stems if zlib.crc32(s.encode()) % 2 == r}
        assert share == want, (r, share, want)
        assert res[r]["succeeded"] == len(want) and res[r]["errors"] == 0
        launches = res[r]["launches"]["flash_rel_attention"]
        assert launches == 24 * res[r]["dispatches"] > 0, res[r]
    assert not shares[0] & shares[1] and shares[0] | shares[1] == set(stems)
    rows = {}
    for r in range(2):
        rows.update(_load_rows(work / f"ids_{r}.npz"))
    n_clear, n = _compare_ids(rows, phase5["rows"], tag)
    walls = [r["wall_s"] for r in res]
    log(f"{tag} backend {res[0]['backend']} ({torch.cuda.device_count()} "
        f"card(s)), devices {[r['device'] for r in res]}; owned "
        f"{[sorted(s) for s in shares]}; batches "
        f"{[r['dispatches'] for r in res]}, flash_rel launches "
        f"{[r['launches']['flash_rel_attention'] for r in res]}")
    log(f"{tag} rows {len(rows)} = phase 5's; ids equal on {n_clear}/{n} "
        f"frames clear in both runs; run walls {walls} s (warmup "
        f"included), e2e RTFx {audio_s / max(walls):.1f} (phase 5: "
        f"{phase5['rtfx']:.1f}); launch wall {res[0]['launch_wall_s']:.1f} s")
    return {"launches": sum(r["launches"]["flash_rel_attention"]
                            for r in res)}


def replica_engine(seed: int, work: Path) -> dict:
    """11b: ``ASREngine`` over a ``data: 2`` mesh (two cards if present,
    else both replicas on cuda:0) against the one-replica engine on the
    same chunks (a copy of the same weights): ids equal off near ties,
    every replica launching the kernel, wall per batch of each."""
    import copy

    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.io.decode import load_audio
    from audio_processor_tpu_torch.models.flash_rel_attention import (
        flash_rel_attention,
    )
    from audio_processor_tpu_torch.parallel.mesh import make_mesh
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
    from audio_processor_tpu_torch.pipeline.chunker import split_audio

    tag = "[11b replicas]"
    cards = torch.cuda.device_count()
    devices = ["cuda:0", "cuda:1"] if cards >= 2 else ["cuda:0"] * 2
    cfg = PipelineConfig.from_dict({"chunk_batch_size": 16,
                                    "enable_mixed_precision": True,
                                    "mesh_shape": {"data": 2}})
    multi = ASREngine(cfg, device="cuda",
                      mesh=make_mesh(data=2, devices=devices))
    one = ASREngine(cfg, device="cuda", model=copy.deepcopy(multi.model),
                    vocab=multi.vocab)
    assert multi.device_chunks == 32 and one.device_chunks == 16
    assert multi.attention_impl == one.attention_impl == "flash_rel"
    per_replica = [0, 0]
    for i, m in enumerate(multi.replicas):
        m.register_forward_pre_hook(
            lambda mod, a, i=i: per_replica.__setitem__(
                i, per_replica[i] - flash_rel_attention.launches))
        m.register_forward_hook(
            lambda mod, a, o, i=i: per_replica.__setitem__(
                i, per_replica[i] + flash_rel_attention.launches))
    chunks = []
    for i in range(5):
        wave, sr = load_audio(work / "input" / f"call-{i:02d}.wav")
        chunks += [c for c in split_audio(wave, sr, f"c{i}", 25.0, 1.0)
                   if c.num_samples == 400000][:4]
    assert len(chunks) == 20
    for eng in (multi, one):
        eng.warmup()
    # Launches and dispatches of the timed passes only (warmup excluded).
    per_replica[:] = [0, 0]
    d_rep = list(multi.replica_dispatches)
    walls = []
    for eng in (multi, one, multi, one):
        torch.cuda.synchronize()
        d0 = eng.dispatches
        t0 = time.perf_counter()
        eng.transcribe_chunks(chunks[:16] if eng is one else chunks)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0, eng.dispatches - d0))
    d_rep = [a - b for a, b in zip(multi.replica_dispatches, d_rep)]
    launched = list(per_replica)
    assert d_rep[0] == d_rep[1] > 0, d_rep
    assert launched == [24 * d for d in d_rep], (launched, d_rep)
    # The ids from one more, untimed pass of each engine under the spy.
    spies = [_IdSpy(multi), _IdSpy(one)]
    multi.transcribe_chunks(chunks)
    one.transcribe_chunks(chunks[:16])
    n_clear, n = _compare_ids(
        {k: v for k, v in spies[0].rows.items() if k in spies[1].rows},
        spies[1].rows, tag)
    log(f"{tag} devices {devices}; per-replica flash_rel launches in the "
        f"timed passes {launched} = 24 x {d_rep} dispatches; ids equal on "
        f"{n_clear}/{n} clear frames of the 16 shared chunks")
    log(f"{tag} wall per 16-chunk slice (48 x 1280 rows each): two "
        f"replicas {walls[0][0] / walls[0][1]:.4f} / "
        f"{walls[2][0] / walls[2][1]:.4f} s, one replica "
        f"{walls[1][0] / walls[1][1]:.4f} / {walls[3][0] / walls[3][1]:.4f}"
        f" s (turns: two, one, two, one)")
    launches = sum(launched)
    del multi, one
    return {"launches": launches}


def _worker_11c(spec: dict, rank: int, world: int) -> dict:
    """One rank of 11c: ``finetune`` under ``mesh_shape: {data: 2}`` with
    ZeRO-1; then the all-reduce of the gradient's bytes, timed alone."""
    import torch.distributed as dist

    from audio_processor_tpu_torch.parallel import collectives as coll
    from audio_processor_tpu_torch.training import finetune as ft

    dev = _join(spec, rank, world)
    steps = []
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, _ = ft.finetune(
        ft.FinetuneConfig(**spec["cfg"]),
        on_step=lambda step, state, loss, times: steps.append(
            {"step": step, "loss": float(loss), **times}))
    peak = torch.cuda.max_memory_allocated(dev)
    run_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    buf = torch.ones(n, device=dev)
    coll.all_reduce_(buf, dist.group.WORLD)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(2):
        coll.all_reduce_(buf, dist.group.WORLD)
    torch.cuda.synchronize(dev)
    return {"backend": dist.get_backend(), "device": str(dev),
            "steps": steps, "peak_bytes": peak, "grad_values": n,
            "all_reduce_s": (time.perf_counter() - t0) / 2,
            "finetune_s": run_s}


def ddp_zero1(seed: int, work: Path, models: Path, train_manifest: Path
              ) -> None:
    """11c: data-parallel fine-tuning with ZeRO-1 at world 2 from phase
    10's HF directory (full width, 24 layers, bf16, remat, SpecAugment),
    2 steps on a global batch of 8 x 25 s, against one process on the
    same global batches; the resume point consolidated on rank 0 loads
    into a one-process state bitwise (a 0-step resume: the sharded run's
    final params and step, every moment), and its moments agree with the
    one-process run's within DDP_MOMENT_RTOL."""
    import dataclasses as dc
    import gc

    from audio_processor_tpu_torch.training import finetune as ft
    from audio_processor_tpu_torch.training import train_step as ts

    tag = "[11c ddp+zero1]"
    base = ft.FinetuneConfig(
        manifest=str(train_manifest), init_checkpoint=str(models / "asr"),
        output_dir=str(work / "one"), num_steps=2, checkpoint_every=0,
        seed=seed, device="cuda")
    assert (base.batch_size, base.max_audio_sec, base.spec_augment) == (
        8, 25.0, True)
    one, last = [], []

    def on_step(step, state, loss, times):
        one.append({"loss": float(loss), **times})
        last[:] = [state]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _ = ft.finetune(base, on_step=on_step)
    one_peak = torch.cuda.max_memory_allocated()
    one_s = time.perf_counter() - t0
    ref_m = ts.named_moments(last.pop())
    ref_m = {k: {n: t.cpu() for n, t in ref_m[k].items()}
             for k in ("exp_avg", "exp_avg_sq")}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mesh_cfg = dc.replace(base, output_dir=str(work / "mesh"),
                          mesh_shape={"data": 2}, zero1=True)
    res = _ranks("11c", work / "ranks", timeout_s=900,
                 cfg=dc.asdict(mesh_cfg))
    for r in res:
        got = [s["loss"] for s in r["steps"]]
        want = [s["loss"] for s in one]
        assert len(got) == 2 and all(
            abs(g - w) <= DDP_LOSS_RTOL * abs(w) for g, w in zip(got, want)), \
            (got, want)
    t0 = time.perf_counter()
    saved = torch.load(work / "mesh" / "step_2" / "params.pt",
                       map_location="cpu", weights_only=True)
    model = ft._load_model(base, torch.device("cuda"), None, None)[0]
    state = ft.load_train_state(ts.init_state(model, ts.make_optimizer()),
                                work / "mesh")
    for name, p in model.named_parameters():
        assert torch.equal(p.detach().cpu(), saved[name]), name
    mom = ts.named_moments(state)
    n_params = len(list(model.parameters()))
    assert state.step == mom["step"] == 2 and len(mom["exp_avg"]) == \
        n_params, (state.step, len(mom["exp_avg"]))
    resume_s = time.perf_counter() - t0
    moment_err = {}
    for key in ("exp_avg", "exp_avg_sq"):
        assert set(mom[key]) == set(ref_m[key])
        per = {}          # name -> (||got - want||^2, ||want||^2, numel)
        for name, w in ref_m[key].items():
            w = w.to(mom[key][name].device)
            per[name] = (float((mom[key][name] - w).double().pow(2).sum()),
                         float(w.double().pow(2).sum()), w.numel())
        total = (sum(v[0] for v in per.values())
                 / sum(v[1] for v in per.values())) ** 0.5
        rms_max = max((v[1] / v[2]) ** 0.5 for v in per.values())
        leaves = {n: (d / w) ** 0.5 for n, (d, w, k) in per.items()
                  if (w / k) ** 0.5 >= DDP_MOMENT_LEAF * rms_max}
        worst = max(leaves, key=leaves.get)
        moment_err[key] = (total, len(leaves), worst, leaves[worst])
        assert total <= DDP_MOMENT_RTOL and leaves[worst] <= \
            DDP_MOMENT_RTOL, (key, moment_err[key])
    del model, state, mom, saved, ref_m
    gc.collect()
    torch.cuda.empty_cache()
    wall = lambda s: s["prep_s"] + s["fwd_bwd_s"] + s["opt_s"]  # noqa: E731
    n = res[0]["grad_values"]
    ar = res[0]["all_reduce_s"]
    step_w = [wall(s) for s in res[0]["steps"]]
    log(f"{tag} backend {res[0]['backend']}, devices "
        f"{[r['device'] for r in res]}; losses one process "
        f"{[round(s['loss'], 4) for s in one]}, world 2 "
        f"{[[round(s['loss'], 4) for s in r['steps']] for r in res]} "
        f"(within {DDP_LOSS_RTOL:g} relative)")
    split = [[round(s[k], 4) for k in ("prep_s", "fwd_bwd_s", "opt_s")]
             for s in res[0]["steps"]]
    log(f"{tag} step wall one process {[round(wall(s), 4) for s in one]} s;"
        f" world 2 rank 0 {[round(w, 4) for w in step_w]} s (prep / fwd+bwd"
        f" / opt {split})")
    log(f"{tag} gradient all-reduce {n} fp32 values ({4 * n / 1e9:.3f} GB) "
        f"per step: {ar:.4f} s alone, {ar / step_w[-1]:.3f} of rank 0's "
        f"last step; peak memory one process {one_peak / 2**30:.2f} GiB, "
        f"ranks {[round(r['peak_bytes'] / 2**30, 2) for r in res]} GiB; "
        f"consolidated resume point loads into one process (step 2, "
        f"{n_params} moment tensors), params bitwise the run's")
    log(f"{tag} consolidated moments against one process's, "
        f"||got - want|| / ||want|| (bound {DDP_MOMENT_RTOL:g}): " + "; ".join(
            f"{k} all {t:.3e}, worst of {n} leaves {w} {e:.3e}"
            for k, (t, n, w, e) in moment_err.items()))
    log(f"{tag} walls: one process {one_s:.1f} s (load, 2 steps, state "
        f"save), ranks {res[0]['launch_wall_s']:.1f} s (of which finetune "
        f"{[round(r['finetune_s'], 1) for r in res]} s, consolidation and "
        f"save included), resume check {resume_s:.1f} s")


def _worker_11d(spec: dict, rank: int, world: int) -> dict:
    """One rank of 11d: a tensor-parallel and a sequence-parallel step,
    then the GPipe forward and step, each from the same weights."""
    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.parallel.mesh import (
        gather_params, make_mesh,
    )
    from audio_processor_tpu_torch.parallel.pipeline import (
        make_pipelined_forward, make_pipelined_train_step, make_stage_mesh,
        stage_parameter_names,
    )
    from audio_processor_tpu_torch.training import train_step as ts

    dev = _join(spec, rank, world)
    work = Path(spec["work"])
    cfg = w2v.W2VBertConfig(**spec["model"])
    weights = torch.load(spec["weights"], map_location=dev)
    batch = {k: v.to(dev) for k, v in torch.load(spec["batch"]).items()}

    def fresh():
        model = w2v.Wav2Vec2Bert(cfg).to(dev)
        model.load_state_dict(weights)
        return model.train()

    out = {}
    for name, shape in (("tp", {"model": 2}), ("sp", {"seq": 2})):
        mesh = make_mesh(world, device="cuda", **shape)
        state = ts.init_state(fresh(), ts.make_optimizer(SHARD_LR),
                              mesh=mesh)
        state, loss = ts.make_train_step(torch.float32, mesh=mesh)(
            state, batch)
        full = gather_params(state.model, mesh)
        if rank == 0:
            torch.save({k: v.cpu() for k, v in full.items()},
                       work / f"{name}.pt")
        out[name] = float(loss)
        del state, full
    mesh = make_stage_mesh(world)
    model = fresh()
    logits = make_pipelined_forward(cfg, mesh, 4)(
        model, batch["features"], batch["feature_mask"].bool())
    state = ts.init_state(model, ts.make_optimizer(SHARD_LR))
    state, loss = make_pipelined_train_step(cfg, mesh, 4)(state, batch)
    names = set(stage_parameter_names(model, mesh))
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()
                if n in names}, work / f"pp_{rank}.pt")
    if rank == 0:
        torch.save(logits.cpu(), work / "pp_logits.pt")
    out["pp"] = float(loss)
    return out


def sharded_strategies(seed: int, work: Path) -> None:
    """11d: tensor parallel (model=2), sequence parallel (seq=2) and GPipe
    (2 stages x 4 microbatches), each at world 2 in fp32 at the full width
    (hidden 1024, 16 heads, FFN 4096, conv 31) with 4 layers, one step
    each against the one-process step on this card."""
    import dataclasses as dc

    from audio_processor_tpu_torch.models import wav2vec2bert as w2v
    from audio_processor_tpu_torch.training import train_step as ts

    tag = "[11d tp/sp/pp]"
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = w2v.W2VBertConfig(num_hidden_layers=SHARD_LAYERS)
    work.mkdir(parents=True, exist_ok=True)
    model = w2v.build_synthetic(cfg, torch.device("cuda"), seed=seed).train()
    before = {n: p.detach().cpu().clone() for n, p in
              model.named_parameters()}
    torch.save(before, work / "w.pt")
    rng = np.random.default_rng(seed)
    fm = np.ones((SHARD_B, SHARD_T), np.float32)
    fm[1, 200:] = fm[3, 150:] = 0.0
    batch = {"features": torch.from_numpy(rng.standard_normal(
                 (SHARD_B, SHARD_T, 160)).astype(np.float32)),
             "feature_mask": torch.from_numpy(fm),
             "labels": torch.from_numpy(rng.integers(
                 1, cfg.vocab_size, (SHARD_B, SHARD_N))),
             "label_mask": torch.ones(SHARD_B, SHARD_N)}
    torch.save(batch, work / "batch.pt")
    res = _ranks("11d", work, timeout_s=600, model=dc.asdict(cfg),
                 weights=str(work / "w.pt"), batch=str(work / "batch.pt"))
    gb = {k: v.cuda() for k, v in batch.items()}
    with torch.no_grad():
        plain = model(gb["features"], gb["feature_mask"].bool()).cpu()
    state, loss = ts.train_step(
        ts.init_state(model, ts.make_optimizer(SHARD_LR)), gb,
        dtype=torch.float32)
    ref = {n: p.detach().cpu() for n, p in model.named_parameters()}
    loss = float(loss)
    pp = {}
    for r in range(2):
        pp.update(torch.load(work / f"pp_{r}.pt"))
    worst = {}
    for name, got in (("tp", torch.load(work / "tp.pt")),
                      ("sp", torch.load(work / "sp.pt")), ("pp", pp)):
        rel = abs(res[0][name] - loss) / abs(loss)
        assert rel <= SHARD_LOSS_RTOL and res[0][name] == res[1][name], \
            (name, res[0][name], res[1][name], loss)
        assert set(got) == set(ref), name
        loose = total = 0
        worst[name] = 0.0
        for n, want in ref.items():
            d = (got[n] - want).abs().max().item()
            tol = SHARD_PARAM_RTOL * max(want.abs().max().item(), 1.0)
            assert d <= tol, (name, n, d, tol)
            worst[name] = max(worst[name], d / tol)
            du = ((got[n] - before[n]) - (want - before[n])).abs()
            loose += int((du > SHARD_LR / 100).sum())
            total += du.numel()
        assert loose <= PARAM_TIGHT_SHARE * total, (name, loose, total)
        log(f"{tag} {name}: loss {res[0][name]:.6f} vs one process "
            f"{loss:.6f} (rel {rel:.2e}); params at worst {worst[name]:.3f} "
            f"of their tolerance; updates beyond lr/100 {loose}/{total}")
    pp_err = (torch.load(work / "pp_logits.pt") - plain).abs().max().item()
    assert pp_err <= 1e-4, pp_err
    log(f"{tag} pipelined forward (2 stages x 4 microbatches) max abs "
        f"{pp_err:.3e} from the plain forward; width hidden "
        f"{cfg.hidden_size}, heads {cfg.num_attention_heads}, ffn "
        f"{cfg.intermediate_size}, conv {cfg.conv_depthwise_kernel_size}, "
        f"{SHARD_LAYERS} layers, batch {SHARD_B} x {SHARD_T} frames, fp32")
    del model, state


def entry_points() -> dict:
    """11e: ``entry()`` at the full geometry (24 kernel launches, ids in
    the vocabulary) and ``dryrun_multichip(2)`` on the card."""
    from audio_processor_tpu_torch import entry as ent

    tag = "[11e entry]"
    fn, args = ent.entry()
    fn(*args)                                   # first use
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = fn(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = _launches()
    vocab = args[0].cfg.vocab_size
    assert counts["flash_rel_attention"] == 24, counts
    assert ids.shape[0] == 4 and int(ids.min()) >= 0 \
        and int(ids.max()) < vocab
    del fn, args
    torch.cuda.empty_cache()
    summary = ent.dryrun_multichip(2)
    assert summary["device"].startswith("cuda")
    assert summary["backend"] == _backend(2)
    assert summary["sharded_inference_chunks"] == 4
    log(f"{tag} entry(): ids {tuple(ids.shape)} in [0, {vocab}), "
        f"{counts['flash_rel_attention']} flash_rel launches, {ms:.1f} ms "
        f"(4 x 25 s, bf16); dryrun_multichip(2): {summary}")
    # The module's entry with no --device runs on the card.
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "audio_processor_tpu_torch.entry",
                        "--devices", "2"], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    (line,) = [ln for ln in r.stdout.splitlines()
               if ln.startswith("dryrun_multichip ok: ")]
    cli = ast.literal_eval(line.split(": ", 1)[1])
    assert cli["device"].startswith("cuda"), cli
    assert cli["backend"] == _backend(2), cli
    log(f"{tag} python -m audio_processor_tpu_torch.entry --devices 2 (no "
        f"--device): device {cli['device']}, backend {cli['backend']}, "
        f"{time.perf_counter() - t0:.1f} s")
    from audio_processor_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices=1)
    assert mesh.devices.flat[0] == torch.device("cuda", 0), mesh.devices
    log(f"{tag} make_mesh(n_devices=1) with no devices: {mesh}, on "
        f"{mesh.devices.flat[0]}")
    return {"launches": counts["flash_rel_attention"]}


def device_resample(seed: int) -> None:
    """11f: ``dsp.resample.resample`` on the card against
    ``resample_np``: 8, 44.1 and 48 kHz to 16 kHz, 2 x 10 s."""
    from audio_processor_tpu_torch.dsp.resample import resample, resample_np

    rng = np.random.default_rng(seed)
    out = []
    for orig in (8000, 44100, 48000):
        x = (0.3 * rng.standard_normal((2, orig * 10))).astype(np.float32)
        xc = torch.from_numpy(x).cuda()
        got = resample(xc, orig, 16000)
        assert got.is_cuda and got.dtype == torch.float32
        err = float(np.abs(got.cpu().numpy()
                           - resample_np(x, orig, 16000)).max())
        assert err <= RESAMPLE_ATOL, (orig, err)
        out.append(f"{orig} Hz: max abs {err:.2e}, "
                   f"{_cuda_ms(lambda: resample(xc, orig, 16000), 10):.3f} ms")
    log(f"[11f resample] card vs resample_np (tol {RESAMPLE_ATOL:g}): "
        + "; ".join(out))


HEADS_PROB_TOL = 1e-5   # phase 12, card heads vs the numpy heads
HEADS_TIE = 1e-4        # labels compared where every |decision| exceeds it


def synthetic_heads(seed: int, n_sv: int = 1500, d: int = 38, k: int = 4,
                    n_trees: int = 100, max_depth: int = 20,
                    max_nodes: int = 1500) -> tuple:
    """Converted acoustic heads as ``sklearn_infer.convert_*`` gives them,
    from a seed (the card has no sklearn): a StandardScaler over the 38
    features, a k-class RBF SVC with ``n_sv`` support vectors, duals in
    [-1, 1] and Platt coefficients, and a forest of ``n_trees`` trees
    grown breadth first (a node splits with probability 0.8, up to
    ``max_depth`` levels and ``max_nodes`` nodes) with a class
    distribution at every node. Returns (scaler, svc, forest, x) with x
    48 raw feature rows."""
    rng = np.random.default_rng(seed)
    scaler = {"mean": rng.normal(0, 3, d).astype(np.float32),
              "scale": rng.uniform(0.5, 4, d).astype(np.float32)}
    n_support = np.full(k, n_sv // k, np.int32)
    n_support[:n_sv - int(n_support.sum())] += 1
    pairs = k * (k - 1) // 2
    classes = np.array(CLIENT_LABELS)
    svc = {"support_vectors": rng.standard_normal((n_sv, d)).astype(
               np.float32),
           "dual_coef": rng.uniform(-1, 1, (k - 1, n_sv)).astype(np.float32),
           "intercept": rng.normal(0, 0.3, pairs).astype(np.float32),
           "n_support": n_support,
           "prob_a": rng.uniform(-4, -1, pairs).astype(np.float32),
           "prob_b": rng.normal(0, 0.2, pairs).astype(np.float32),
           "gamma": np.float32(1.0 / d), "kernel": "rbf",
           "coef0": np.float32(0.0), "degree": 3, "classes": classes}
    trees = []
    for _ in range(n_trees):
        left, right, feat, thr, depth = [-1], [-1], [0], [0.0], [0]
        frontier = [0]
        while frontier:
            grown = []
            for n in frontier:
                if depth[n] < max_depth and len(left) + 2 <= max_nodes \
                        and rng.random() < 0.8:
                    feat[n] = int(rng.integers(d))
                    thr[n] = float(rng.normal(0, 0.7))
                    for side in (left, right):
                        side[n] = len(left)
                        left.append(-1)
                        right.append(-1)
                        feat.append(0)
                        thr.append(0.0)
                        depth.append(depth[n] + 1)
                        grown.append(side[n])
            frontier = grown
        trees.append((left, right, feat, thr, max(depth)))
    N = max(len(t[0]) for t in trees)
    forest = {"left": np.full((n_trees, N), -1, np.int32),
              "right": np.full((n_trees, N), -1, np.int32),
              "feature": np.zeros((n_trees, N), np.int32),
              "threshold": np.zeros((n_trees, N), np.float32),
              "value": np.zeros((n_trees, N, k), np.float32),
              "max_depth": max(t[4] for t in trees), "classes": classes}
    for i, (lft, rgt, feat, thr, _) in enumerate(trees):
        n = len(lft)
        forest["left"][i, :n], forest["right"][i, :n] = lft, rgt
        forest["feature"][i, :n], forest["threshold"][i, :n] = feat, thr
        forest["value"][i, :n] = rng.dirichlet(np.ones(k), n)
    x = (scaler["mean"] + scaler["scale"]
         * rng.standard_normal((48, d))).astype(np.float32)
    return scaler, svc, forest, x


def _host_ms(fn, reps: int = 20) -> float:
    """Median wall ms of ``fn`` over ``reps`` calls, each ending in a
    device synchronise (the heads' coupling loop syncs as it goes)."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def acoustic_heads(seed: int) -> None:
    """12: the device acoustic heads (``sklearn_infer.scaler_transform``,
    ``svc_predict_proba``/``svc_predict`` and ``forest_predict_proba``/
    ``forest_predict``) on the card against the port's numpy heads, which
    the pipeline runs, at B = 48 on seeded converted dicts (a 4-class
    RBF SVC with 1,500 support vectors of 38 dims, a 100-tree forest of
    depth <= 20)."""
    from audio_processor_tpu_torch.models import sklearn_infer as sk

    tag = "[12 heads]"
    scaler, svc, forest, x = synthetic_heads(seed + 12)
    on_card = {name: sk.to_device(m, "cuda")
               for name, m in (("scaler", scaler), ("svc", svc),
                               ("forest", forest))}
    xc = torch.from_numpy(x).cuda()
    xs = sk.scaler_transform(on_card["scaler"], xc)
    xs_np = sk.scaler_transform_np(scaler, x)
    scaler_err = float(np.abs(xs.cpu().numpy() - xs_np).max())
    assert scaler_err <= HEADS_PROB_TOL * max(1.0, np.abs(xs_np).max()), \
        scaler_err
    dec = sk.svc_decision_values(on_card["svc"], xs).cpu().numpy()
    dec_np = sk._svc_decision_values_np(svc, xs_np)
    proba = sk.svc_predict_proba(on_card["svc"], xs).cpu().numpy()
    proba_np = sk.svc_predict_proba_np(svc, xs_np)
    svc_err = float(np.abs(proba - proba_np).max())
    assert svc_err <= HEADS_PROB_TOL, svc_err
    clear = (np.abs(dec_np) > HEADS_TIE).all(-1)
    pred = sk.svc_predict(on_card["svc"], xs).cpu().numpy()
    assert clear.sum() >= 40, clear.sum()
    assert (pred[clear] == sk.svc_predict_np(svc, xs_np)[clear]).all()
    fproba = sk.forest_predict_proba(on_card["forest"], xs).cpu().numpy()
    fproba_np = sk.forest_predict_proba_np(forest, xs_np)
    forest_err = float(np.abs(fproba - fproba_np).max())
    assert forest_err <= HEADS_PROB_TOL, forest_err
    top2 = np.sort(fproba_np, -1)[:, -2:]
    fclear = top2[:, 1] - top2[:, 0] > HEADS_PROB_TOL
    fpred = sk.forest_predict(on_card["forest"], xs).cpu().numpy()
    assert (fpred[fclear] == sk.forest_predict_np(forest, xs_np)[fclear]
            ).all()
    assert xs.is_cuda and np.isfinite(proba).all()

    card_ms = {
        "scaler_transform": _host_ms(
            lambda: sk.scaler_transform(on_card["scaler"], xc)),
        "svc_predict_proba": _host_ms(
            lambda: sk.svc_predict_proba(on_card["svc"], xs)),
        "forest_predict_proba": _host_ms(
            lambda: sk.forest_predict_proba(on_card["forest"], xs))}
    numpy_ms = {
        "scaler_transform": _host_ms(
            lambda: sk.scaler_transform_np(scaler, x)),
        "svc_predict_proba": _host_ms(
            lambda: sk.svc_predict_proba_np(svc, xs_np)),
        "forest_predict_proba": _host_ms(
            lambda: sk.forest_predict_proba_np(forest, xs_np))}
    log(f"{tag} card vs numpy heads at B=48: scaler max abs "
        f"{scaler_err:.2e}; SVC (4 classes, {svc['support_vectors'].shape[0]}"
        f" support vectors) proba max abs {svc_err:.2e}, labels equal on "
        f"{int(clear.sum())}/48 rows clear of |dec| <= {HEADS_TIE:g}; forest "
        f"({forest['left'].shape[0]} trees, {forest['left'].shape[1]} nodes, "
        f"depth {forest['max_depth']}) proba max abs {forest_err:.2e}, labels"
        f" equal on {int(fclear.sum())}/48 rows (tol {HEADS_PROB_TOL:g})")
    log(f"{tag} ms per call (median of 20, host clock, synchronised): card "
        + ", ".join(f"{k} {v:.3f}" for k, v in card_ms.items())
        + "; numpy on the host "
        + ", ".join(f"{k} {v:.3f}" for k, v in numpy_ms.items()))


WORKERS = {"11a": _worker_11a, "11c": _worker_11c, "11d": _worker_11d}


def rank_worker(phase: str, rank: int, world: int, spec: dict) -> int:
    """A rank process of phase 11: runs ``phase``'s worker and leaves its
    result in the work directory."""
    import torch.distributed as dist

    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    result = WORKERS[phase](spec, rank, world)
    (Path(spec["work"]) / f"rank{rank}.json").write_text(json.dumps(result))
    log(f"{phase} rank {rank}: done")
    dist.destroy_process_group()
    return 0


def _graph_ms(fn, reps: int) -> float:
    """Card ms of ``fn``'s launches, captured once as a CUDA graph and
    replayed, so that the host's launch costs stay out of the time (the
    decode loop runs them as a graph too); kernel-wrapper launches of the
    capture are not counted."""
    from audio_processor_tpu_torch.models import _cuda_call

    fn()
    graph = torch.cuda.CUDAGraph()
    with _cuda_call.tally_launches(), torch.cuda.graph(graph):
        fn()
    return _cuda_ms(graph.replay, reps)


def decode_attention_check(st, seed: int) -> dict:
    """Phase 13's check of the decode-attention kernel against its plain
    version at the decoder's shapes (48 rows x 16 heads x 64, the state's
    288-position caches and 161 adaptor frames): self at positions 0, 31,
    32 and 102 (outputs, and the caches after the write equal), cross
    with 157 valid frames and ragged rows, one with none; bf16 and fp32.
    Then us per launch over the 24 layers' buffers of ``st`` (cold in L2,
    as in the loop: 24 x 31.7 MB of cross K/V), beside the byte bound, the
    plain version's us and the library's (``scaled_dot_product_attention``
    on the same buffers, after the two ``index_copy_`` cache writes in
    self mode): cross, and self at positions 52 and 102."""
    from audio_processor_tpu_torch.models import decode_attention as da

    dev = st.pos.device
    R, nh, C, d = st.k.shape[1:]
    frames = st.ck.shape[3]
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(seed + 43)
    tol = {torch.bfloat16: dict(atol=1e-3, rtol=1e-2),
           torch.float32: dict(atol=1e-5, rtol=1e-5)}
    valid = torch.full((R,), frames - 4, device=dev)
    valid[1:8] = torch.tensor([150, 131, 94, 76, 40, 1, 0], device=dev)
    bias = torch.where(
        torch.arange(frames, device=dev)[None] < valid[:, None], 0.0,
        torch.finfo(torch.float32).min)
    err = {}

    def rand(*shape, dtype, s=1.0):
        return (s * torch.randn(*shape, device=dev, generator=gen)) \
            .to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        k, v = rand(R, nh, C, d, dtype=dtype, s=2.0), rand(R, nh, C, d,
                                                           dtype=dtype)
        for p in (0, 31, 32, 102):
            q, kn = (rand(R, nh * d, dtype=dtype, s=2.0) for _ in range(2))
            vn = rand(R, nh * d, dtype=dtype)
            pos = torch.tensor([p], device=dev)
            kp, vp = k.clone(), v.clone()
            got = da.decode_attention(q, k, v, scale, pos=pos, k_new=kn,
                                      v_new=vn)
            want = da.decode_attention_plain(q, kp, vp, scale, pos=pos,
                                             k_new=kn, v_new=vn)
            torch.testing.assert_close(got.float(), want.float(),
                                       **tol[dtype])
            assert torch.equal(k, kp) and torch.equal(v, vp), p
            err[f"{name}.self{p}"] = float((got.float() - want.float())
                                           .abs().max())
        q = rand(R, nh * d, dtype=dtype, s=2.0)
        ck, cv = rand(R, nh, frames, d, dtype=dtype, s=2.0), \
            rand(R, nh, frames, d, dtype=dtype)
        got = da.decode_attention(q, ck, cv, scale, bias=bias)
        want = da.decode_attention_plain(q, ck, cv, scale, bias=bias)
        torch.testing.assert_close(got.float(), want.float(), **tol[dtype])
        torch.testing.assert_close(          # the row with no valid frame
            got[7].float(), cv[7].float().mean(dim=1).reshape(-1),
            atol=1e-2 if dtype == torch.bfloat16 else 1e-5, rtol=0)
        err[f"{name}.cross"] = float((got.float() - want.float())
                                     .abs().max())
        del k, v, ck, cv
    log(f"[13 s2t] decode attention kernel = plain at {R} x {nh} x {d}: "
        f"max abs err {err}")

    layers = st.k.shape[0]
    dtype = st.k.dtype
    e = torch.finfo(dtype).bits // 8
    q = rand(R, nh * d, dtype=dtype)
    kn, vn = rand(R, nh * d, dtype=dtype), rand(R, nh * d, dtype=dtype)
    rows = R * nh * d * e               # one [R, H*d] tensor's bytes
    timed = {}

    def heads(t):                       # [R, H*d] -> [R, H, 1, d], a view
        return t.view(R, 1, nh, d).transpose(1, 2)

    keep = (st.enc_bias == 0)[:, None, None, :]
    cases = {"cross": (dict(bias=st.enc_bias), lambda i: (st.ck[i],
                                                           st.cv[i]),
                       2 * rows + 2 * R * nh * frames * d * e
                       + R * frames * 4,
                       lambda i: F.scaled_dot_product_attention(
                           heads(q), st.ck[i], st.cv[i], attn_mask=keep,
                           scale=scale))}

    def library_self(i, p, pos):
        st.k[i].index_copy_(2, pos, heads(kn))
        st.v[i].index_copy_(2, pos, heads(vn))
        return F.scaled_dot_product_attention(
            heads(q), st.k[i][:, :, :p + 1], st.v[i][:, :, :p + 1],
            scale=scale)

    for p in (52, 102):
        pos = torch.tensor([p], device=dev)
        cases[f"self{p}"] = (
            dict(pos=pos, k_new=kn, v_new=vn),
            lambda i: (st.k[i], st.v[i]),
            # q, k_new, v_new read, out and the cache row written, the
            # cache's first p positions read
            6 * rows + 2 * R * nh * p * d * e,
            lambda i, p=p, pos=pos: library_self(i, p, pos))
    for name, (kw, kv, nbytes, lib) in cases.items():
        def kernel():
            for i in range(layers):
                da.decode_attention(q, *kv(i), scale, **kw)

        def plain():
            for i in range(layers):
                da.decode_attention_plain(q, *kv(i), scale, **kw)

        def library():
            for i in range(layers):
                lib(i)

        us = 1e3 * _graph_ms(kernel, 20) / layers
        plain_us = 1e3 * _graph_ms(plain, 5) / layers
        library_us = 1e3 * _graph_ms(library, 20) / layers
        timed[name] = {"us": us, "plain_us": plain_us,
                       "library_us": library_us,
                       "bound_us": 1e6 * nbytes / 3.35e12,
                       "bytes": nbytes}
    log(f"[13 s2t] decode attention us per launch (bound: bytes / 3.35 "
        f"TB/s): {json.dumps(timed)}")
    return {"max_abs_err": err, "timed": timed}


def step_kernels(graph) -> dict:
    """The device work one replay of a decode step's graph runs: a
    ``torch.profiler`` window around one replay, its Chrome trace's
    kernel, copy and set events counted, and the kernel time summed."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        graph.replay()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kinds = {}
    kernel_us = 0.0
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            kinds[e["cat"]] = kinds.get(e["cat"], 0) + 1
            if e["cat"] == "kernel":
                kernel_us += float(e.get("dur", 0.0))
    attn = [float(e.get("dur", 0.0)) for e in events if e.get("ph") == "X"
            and e.get("cat") == "kernel" and "decode_attention" in
            e.get("name", "")]
    assert kinds.get("kernel", 0) > 0, kinds
    out = {"events": kinds, "kernel_us": kernel_us,
           "decode_attention_kernels": len(attn),
           "decode_attention_us": sum(attn)}
    log(f"[13 s2t] one replayed step (profiler window): {out}")
    return out


def s2t_phase(seed: int) -> dict:
    """Phase 13: SeamlessM4T v2 speech-to-text at its published widths
    (random weights from the seed, bf16, the decoder's weights cast once)
    on one 48-row device batch of 25 s chunks (1,249 valid frames of 1280,
    157 adaptor frames, a cap of 103 tokens per row): the speech encoder's
    graph (capture, two replays) equals its eager body bit for bit with 24
    flash_rel launches per call and none from the adaptor; the decode loop
    run step by step eagerly, then by ``generate`` twice (capture, replay),
    gives the same tokens and the same logits at three steps bit for bit;
    prints host ms to return and card ms per step, eager and replayed, the
    speech encoder's card ms and the peak device memory."""
    from audio_processor_tpu_torch.models import seamless_s2t as s2t
    from audio_processor_tpu_torch.models.decode_attention import (
        decode_attention as da_fn,
    )
    from audio_processor_tpu_torch.obs import profiler

    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats(dev)
    model = s2t.build_synthetic(s2t.S2TConfig(), dev, seed=seed) \
        .cast_decoder(torch.bfloat16)
    enc_m, dec = model.speech_encoder, model.text_decoder
    lang = model.cfg.vocab_size - 1
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    x = torch.randn(48, 1280, 160, device=dev, generator=gen)
    mask = (torch.arange(1280, device=dev) < 1249)[None].expand(48, -1) \
        .contiguous()
    x = x * mask[..., None]
    rel = _counters()["flash_rel_attention"]
    out = {}
    with torch.inference_mode():
        want = enc_m._encode(x, mask, torch.bfloat16, "flash_rel")
        launched = []
        for _ in range(3):
            before = rel.launches
            got = enc_m(x, mask, dtype=torch.bfloat16,
                        attention_impl="flash_rel")
            launched.append(rel.launches - before)
            if not torch.equal(got, want):
                raise AssertionError("[13 s2t] speech encoder replay != "
                                     "eager")
        if launched != [24, 24, 24]:
            raise AssertionError(f"[13 s2t] flash_rel launches {launched}")
        emask = enc_m.output_mask(mask)
        caps_h = model.caps([400000] * 48)
        steps = max(caps_h)
        assert int(emask[0].sum()) == 157 and steps == 103, (emask.sum(1),
                                                              caps_h)
        caps = torch.tensor(caps_h, device=dev)
        taps = {0, steps // 2, steps - 1}
        st = dec._state(48, want.shape[1], torch.bfloat16, want.device)

        def eager():
            dec.reset(st, caps)
            kept = {}
            for pos in range(steps + 1):
                dec._step(st, lang)
                if pos - 1 in taps:
                    kept[pos - 1] = st.logits.clone()
            return st.ids[:, :steps].clone(), kept

        dec.cross_kv(st, want, emask)
        ids_e, logits_e = eager()
        dec.tap_steps = lambda n: taps
        for call in ("capture", "replay"):
            with profiler.recording_spans():
                seen = {sp.id for sp in profiler.spans()}
                ids, text, _ = dec.generate(want, emask, caps, steps, lang)
                modes = [sp.attrs["mode"] for sp in profiler.spans()
                         if sp.id not in seen and sp.name == "decoder.graph"]
            if modes != [call]:
                raise AssertionError(f"[13 s2t] decode {call}: spans of "
                                     f"modes {modes}")
            diff = {g: float((dec.tapped[g].float()
                              - logits_e[g].float()).abs().max())
                    for g in taps}
            if not torch.equal(ids, ids_e) or any(diff.values()):
                raise AssertionError(
                    f"[13 s2t] decode {call} != eager: ids equal "
                    f"{torch.equal(ids, ids_e)}, logit max diff {diff}")
            assert int(text.sum()) == 48 * steps, "a row stopped early"
        dec.tap_steps = None
        assert list(st.graphs) == [lang], list(st.graphs)
        out["decode_attention"] = decode_attention_check(st, seed)
        da_fn.launches = 0              # the main path's run alone, below
        with profiler.recording_spans():
            seen = {sp.id for sp in profiler.spans()}
            dec.generate(want, emask, caps, steps, lang)
            spans = [sp for sp in profiler.spans() if sp.id not in seen
                     and sp.name == "decoder.graph"]
        launches = da_fn.launches
        per_step = 2 * model.cfg.decoder_layers
        tallied = [e.launches for e in st.graphs.values()]
        assert tallied and all(t == {da_fn: per_step} for t in tallied), \
            tallied
        assert sum(sp.attrs["steps"] for sp in spans) == steps + 1 and all(
            sp.attrs["attn_launches"] == per_step * sp.attrs["steps"]
            for sp in spans), [sp.attrs for sp in spans]
        assert launches == per_step * (steps + 1) == sum(
            sp.attrs["attn_launches"] for sp in spans), launches
        out["decode_attention"]["launches"] = launches
        out["step_kernels"] = step_kernels(st.graphs[lang].graph)
        for label, fn in (("eager", eager),
                          ("replay", lambda: dec.decode(st, caps, steps,
                                                        lang))):
            host = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                host.append(1e3 * (time.perf_counter() - t0))
            out[label] = {"host_ms_per_step": float(np.median(host))
                          / (steps + 1),
                          "card_ms_per_step": _cuda_ms(fn, 3) / (steps + 1)}
        out["speech_encoder_card_ms"] = _cuda_ms(
            lambda: enc_m(x, mask, dtype=torch.bfloat16,
                          attention_impl="flash_rel"), 3)
        out["cross_kv_card_ms"] = _cuda_ms(
            lambda: dec.cross_kv(st, want, emask), 3)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"[13 s2t] 48 rows x 1280 frames, 103 steps: replay = eager bit "
        f"for bit (encoder, tokens, logits at steps {sorted(taps)}); "
        f"{per_step} decode-attention launches per step graph and per "
        f"step of every decoder.graph span; {json.dumps(out)}")
    del model, enc_m, dec, st
    torch.cuda.empty_cache()
    return out


def _mla_old_decode(attn, x, cos, sin, cache, pos, visible):
    """``moe_lm.LatentAttention.decode`` before the MLA kernels, verbatim:
    the absorbed composition that phase 14b times beside them, that its
    fp32 run holds the decode to, and that the CPU tests hold the kernels'
    plain versions to."""
    cfg = attn.cfg
    q_nope, q_pe, latent = attn.project(x, cos, sin)
    cache.scatter_(1, pos[:, None, None].expand(-1, 1, latent.shape[-1]),
                   latent[:, None])
    w = attn.kv_b_proj.weight.unflatten(0, (attn.nh, -1))
    w_k, w_v = w.split([cfg.qk_nope_head_dim, cfg.v_head_dim], dim=1)
    q_lat = torch.einsum("rhd,hdc->rhc", q_nope, w_k)
    q = torch.cat([q_lat, q_pe], dim=-1)
    scores = torch.bmm(q, cache.transpose(1, 2)).float() * attn.scale
    scores = scores.masked_fill(~visible[:, None], float("-inf"))
    p = scores.softmax(dim=-1).to(x.dtype)
    o_lat = torch.bmm(p, cache[..., :cfg.kv_lora_rank])
    o = torch.einsum("rhc,hdc->rhd", o_lat, w_v)
    return F.linear(o.flatten(1), attn.o_proj.weight)


def _graph_kernels(fn) -> int:
    """Kernels the card runs in one replay of ``fn`` captured as a CUDA
    graph (a ``torch.profiler`` window around the replay)."""
    from audio_processor_tpu_torch.models import _cuda_call

    fn()
    graph = torch.cuda.CUDAGraph()
    with _cuda_call.tally_launches(), torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _mla_library_us(q_lat, q_pe, caches, visible, scale: float):
    """us per layer of ``F.scaled_dot_product_attention`` computing
    :func:`mla_decode.mla_decode_attention` over each of ``caches``
    [layers, R, C, 576] in a graph: the query [R, H, 1, 576], the key the
    cache and the value its first 512 dims, both expanded over the heads
    without a copy, the mask ``visible``. Held to the plain version within
    1e-2 first; None, with the reason logged, where SDPA refuses it."""
    from audio_processor_tpu_torch.models import mla_decode as md

    lora = q_lat.shape[-1]
    H = q_lat.shape[0]
    q = torch.cat([q_lat.transpose(0, 1), q_pe], dim=-1)[:, :, None]
    mask = visible[:, None, None]

    def library(c):
        return F.scaled_dot_product_attention(
            q, c[:, None].expand(-1, H, -1, -1),
            c[:, None, :, :lora].expand(-1, H, -1, -1), attn_mask=mask,
            scale=scale)

    try:
        with torch.inference_mode():
            got = library(caches[0])[:, :, 0].transpose(0, 1)
            want = md.mla_decode_attention_plain(q_lat, q_pe, caches[0],
                                                 visible, scale)
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=1e-2, rtol=1e-2)
            return 1e3 * _graph_ms(lambda: [library(c) for c in caches],
                                   20) / caches.shape[0]
    except RuntimeError as e:
        log(f"[14b] SDPA does not take the absorbed attention: {e}")
        return None


def mla_decode_check(seed: int) -> dict:
    """Phase 14b: the topic LM's MLA decode kernels
    (``models/mla_decode.py``) at the topics cell's shapes: Moonlight's
    attention widths (16 heads, latent 512 + 64) with drawn bf16 weights,
    8 rows at ragged positions 1,270-1,470 of a 1,536 capacity and
    3,890-4,000 of 4,096, each layer's cache the first positions of an
    8,192-position buffer (as the decode state's). The prep against its
    plain version (q_nope, q_pe bit for bit; the cached latent within a
    bf16 step; nothing else of the cache written), the attention against
    its plain version (within 1e-2) under the causal mask and one with
    holes; the decode's relative error against the decode before the
    kernels (``_mla_old_decode``) run in fp32 on the same values, beside
    that composition's own in bf16; a CUDA graph of all 27 layers'
    decodes replayed equal to the eager run. Then, over 27 layers' caches
    (cold in L2, as in the step), us per launch of each kernel beside its
    byte bound and its plain version, the attention also beside the one
    library call that computes it (``F.scaled_dot_product_attention``
    with head size 576 for the key and 512 for the value, both the cache
    expanded over the heads), and us per layer of the whole decode (its
    projections included) beside the composition before the kernels, with
    the kernels each runs in a graph."""
    from audio_processor_tpu_torch.models import mla_decode as md
    from audio_processor_tpu_torch.models import moe_lm

    dev = torch.device(DEVICE)
    cfg = moe_lm.MoELMConfig()
    layers, R, nh = cfg.num_hidden_layers, 8, cfg.num_attention_heads
    torch.manual_seed(seed + 61)
    attn = moe_lm.LatentAttention(cfg)
    with torch.no_grad():
        for name, p in attn.named_parameters():
            if "layernorm" in name:
                p.copy_(1 + 0.2 * torch.randn(p.shape))
            else:
                p.normal_(0.0, 0.04 if "kv_a" not in name else 0.02)
    exact = attn.to(dev).eval()
    attn = moe_lm.LatentAttention(cfg).to(dev)
    attn.load_state_dict(exact.state_dict())
    attn = attn.to(torch.bfloat16).eval().requires_grad_(False)
    exact = exact.to(torch.bfloat16).float().requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(seed + 62)
    buf = torch.randn(layers, R, cfg.max_position_embeddings,
                      cfg.latent_dim, device=dev, generator=gen) \
        .to(torch.bfloat16)
    cos_t, sin_t = moe_lm.rope_tables(cfg, dev)
    slots = torch.arange(cfg.max_position_embeddings, device=dev)
    norm = attn.kv_a_layernorm
    w = attn.kv_b_proj.weight.unflatten(0, (nh, -1))
    w_k = w[:, :cfg.qk_nope_head_dim]
    out: dict = {"err": {}, "timed": {}}
    for cap, lo, hi in ((1536, 1270, 1470), (4096, 3890, 4000)):
        pos = torch.randint(lo, hi, (R,), device=dev, generator=gen)
        cos, sin = cos_t[pos], sin_t[pos]
        visible = slots[None, :cap] <= pos[:, None]
        holes = visible & (torch.rand(R, cap, device=dev, generator=gen)
                           > 0.3)
        holes[:, 0] = True
        x = torch.randn(R, cfg.hidden_size, device=dev, generator=gen) \
            .to(torch.bfloat16)
        with torch.inference_mode():
            q, kv = attn.q_proj(x), attn.kv_a_proj_with_mqa(x)
            cache = buf[0, :, :cap]
            plain_cache = cache.clone()
            args = (q, kv, cos, sin, norm.weight, norm.eps)
            got = md.mla_decode_prep(*args, cache, pos, nh)
            want = md.mla_decode_prep_plain(*args, plain_cache, pos, nh)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            rows = torch.arange(R, device=dev)
            a, b = cache[rows, pos].float(), plain_cache[rows, pos].float()
            steps = float(((a - b).abs() / (b.abs() * 2 ** -8 + 1e-6))
                          .max())
            assert steps <= 2.0, steps
            out["err"][f"prep_latent.{cap}"] = float((a - b).abs().max())
            cache[rows, pos] = plain_cache[rows, pos]
            assert torch.equal(cache, plain_cache)
            q_lat = torch.bmm(got[0], w_k)
            for mname, mask in (("causal", visible), ("holes", holes)):
                o = md.mla_decode_attention(q_lat, got[1], cache, mask,
                                            attn.scale)
                p = md.mla_decode_attention_plain(q_lat, got[1], cache,
                                                  mask, attn.scale)
                torch.testing.assert_close(o.float(), p.float(), atol=1e-2,
                                           rtol=1e-2)
                out["err"][f"attention.{cap}.{mname}"] = float(
                    (o.float() - p.float()).abs().max())
            out["err"][f"latent_bf16_steps.{cap}"] = steps
            # the decode's error against the old composition in fp32 (the
            # card decodes only in bf16), the old one's in bf16 beside it
            ref = _mla_old_decode(exact, x.float(), cos, sin, cache.float(),
                                  pos, visible)
            new = attn.decode(x, cos, sin, cache, pos, visible)
            old = _mla_old_decode(attn, x, cos, sin, cache.clone(), pos,
                                  visible)
            out["err"][f"decode_rel.{cap}"] = float(
                (new.float() - ref).norm() / ref.norm())
            out["err"][f"old_decode_rel.{cap}"] = float(
                (old.float() - ref).norm() / ref.norm())
            # all layers' decodes in one graph, replayed = eager
            def all_layers(fn, x=x, cos=cos, sin=sin, pos=pos,
                           visible=visible, cap=cap):
                return [fn(attn, x, cos, sin, buf[i, :, :cap], pos, visible)
                        for i in range(layers)]

            def new_decode(a, *rest):
                return a.decode(*rest)

            eager = all_layers(new_decode)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = all_layers(new_decode)
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(eager, captured))
        if cap != 1536:
            continue
        # times over the 27 layers' caches
        rest = (x, cos, sin)
        vis_bytes = int((pos + 1).sum()) * cfg.latent_dim * 2
        e = 2
        prep_bytes = e * R * (nh * cfg.qk_head_dim + 2 * cfg.latent_dim
                              + nh * cfg.qk_head_dim) + 4 * 2 * R * 64 \
            + e * cfg.kv_lora_rank
        attn_bytes = vis_bytes + e * R * nh * (2 * cfg.kv_lora_rank + 64) \
            + R * cap
        cases = {
            "prep": (lambda i: md.mla_decode_prep(
                *args, buf[i, :, :cap], pos, nh), prep_bytes),
            "attention": (lambda i: md.mla_decode_attention(
                q_lat, got[1], buf[i, :, :cap], visible, attn.scale),
                attn_bytes),
            "decode": (lambda i: attn.decode(*rest, buf[i, :, :cap], pos,
                                             visible), None),
            "old_decode": (lambda i: _mla_old_decode(
                attn, *rest, buf[i, :, :cap], pos, visible), None)}
        with torch.inference_mode():
            for name, (fn, nbytes) in cases.items():
                def run(fn=fn):
                    for i in range(layers):
                        fn(i)

                us = 1e3 * _graph_ms(run, 20) / layers
                rec = {"us": us, "kernels_per_layer":
                       _graph_kernels(run) / layers}
                if nbytes is not None:
                    rec.update(bound_us=1e6 * nbytes / 3.35e12,
                               bytes=nbytes)
                if name == "prep":
                    rec["plain_us"] = 1e3 * _graph_ms(
                        lambda: [md.mla_decode_prep_plain(
                            *args, buf[i, :, :cap], pos, nh)
                            for i in range(layers)], 5) / layers
                if name == "attention":
                    rec["plain_us"] = 1e3 * _graph_ms(
                        lambda: [md.mla_decode_attention_plain(
                            q_lat, got[1], buf[i, :, :cap], visible,
                            attn.scale) for i in range(layers)], 5) / layers
                    rec["library_us"] = _mla_library_us(
                        q_lat, got[1], buf[:, :, :cap], visible, attn.scale)
                out["timed"][name] = rec
    log(f"[14b] MLA decode kernels = plain at {R} rows x {nh} heads, "
        f"capacities 1,536 and 4,096: {json.dumps(out['err'])}")
    log(f"[14b] us per launch / per layer over {layers} layers' caches "
        f"(bound: bytes / 3.35 TB/s): {json.dumps(out['timed'])}; "
        f"{smi_line()}")
    del buf, attn, exact
    torch.cuda.empty_cache()
    return out


def _kda_layer(dev, seed: int):
    """A KDA layer at Kimi-Linear's widths (hidden 2,304, 32 heads of 128)
    with stand-in bf16 weights (``kda.stand_in``; A_log, dt_bias fp32)."""
    from types import SimpleNamespace

    from audio_processor_tpu_torch.models import kda

    cfg = SimpleNamespace(kda_num_heads=32, kda_head_dim=128,
                          kda_conv_size=4, hidden_size=2304,
                          rms_norm_eps=1e-5)
    layer = kda.KimiDeltaAttention(cfg).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            kda.stand_in(name, p, gen)
    layer = layer.to(torch.bfloat16).eval().requires_grad_(False)
    for name in ("A_log", "dt_bias"):
        getattr(layer, name).data = getattr(layer, name).data.float()
    return layer


def _kda_chunk_flops(L: int, D: int = 128, n_c: int = 64) -> int:
    """Operations of the chunkwise KDA form over one head of an L-token
    row: per chunk of n the decayed q.k and k.k pairs, the triangular
    solve, w and u, and the state pass (w.S, q.S, A.v_new, k_d^T.v_new)."""
    full, rem = divmod(L, n_c)
    total = 0
    for n in [n_c] * full + ([rem] if rem else []):
        incl, strict = n * (n + 1) // 2, n * (n - 1) // 2
        total += (2 * D * (incl + strict) + n ** 3 + 2 * 2 * D * incl
                  + 3 * 2 * n * D * D + 2 * D * incl)
    return total


def kda_prefill_check(layer, dev, gen) -> tuple:
    """Phase 15d: the KDA prefill kernel (``csrc/kda_prefill.cu``) against
    its plain twin over 8 ragged rows of the topics prompts' lengths (≈
    1,270 and ≈ 3,960 tokens) at Kimi-Linear's widths, the inputs
    projected by ``layer``; then ms per layer beside the twin's and the
    bound (operations at the fp32 FFMA peak or bytes at 3.35 TB/s).
    -> ({length: errors}, {length: times})."""
    from audio_processor_tpu_torch.models import kda

    R, H, D, W = 8, layer.H, layer.D, layer.W
    errs, timed = {}, {}
    for L in (1270, 3960):
        lengths = [L - 37 * r for r in range(R)]
        rows = [(sum(lengths[:r]), n) for r, n in enumerate(lengths)]
        N = sum(lengths)
        x = torch.randn(N, 2304, device=dev, generator=gen) \
            .to(torch.bfloat16)
        with torch.inference_mode():
            p = F.linear(x, layer.in_proj.weight)
            _, fg, _ = layer._split(p)
            args = (p, fg, layer.conv_weight, layer.A_log, layer.dt_bias,
                    layer.g_bias, layer.o_norm, layer.eps)
            st = torch.zeros(R, H, D, D, device=dev)
            cv = torch.zeros(R, 3, 3 * W, device=dev, dtype=torch.bfloat16)
            st2, cv2 = st.clone(), cv.clone()
            got = kda.kda_prefill(*args, rows, st, cv)
            want = kda.kda_prefill_plain(*args, rows, st2, cv2)
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                       rtol=1e-2)
            rel = [float((st[r].double() - st2[r].double()).pow(2).sum()
                         / st2[r].double().pow(2).sum()) for r in range(R)]
            assert max(rel) <= 1e-7 and torch.equal(cv, cv2), (L, rel)
            errs[L] = {"out_max_abs": float((got.float() - want.float())
                                            .abs().max()),
                       "state_rel_mse_max": max(rel)}
            ms = _cuda_ms(lambda: kda.kda_prefill(*args, rows, st, cv), 10)
            plain_ms = _cuda_ms(lambda: kda.kda_prefill_plain(
                *args, rows, st2, cv2), 2)
        ops = H * sum(_kda_chunk_flops(n, D) for n in lengths)
        nbytes = (2 * N * (6 * W + H) + 4 * R * H * D * D
                  + 2 * R * 3 * 3 * W + 2 * (3 * W * 4 + W + D)
                  + 4 * (H + W))
        timed[L] = {"ms": ms, "plain_ms": plain_ms,
                    "bound_ms": 1e3 * max(ops / FP32_FLOPS,
                                          nbytes / HBM_BYTES_S),
                    "bound_by": "operations" if ops / FP32_FLOPS
                    > nbytes / HBM_BYTES_S else "bytes",
                    "tflop": ops / 1e12, "gb": nbytes / 1e9}
        del x, p, fg, args, st, cv, st2, cv2, got, want
    return errs, timed


def kimi_phase(seed: int) -> dict:
    """Phase 15 (see the module's notes): the KDA decode kernel, the MLA
    kernels at 32 heads without rotation, and the launches of a
    graph-replayed hybrid's steps. -> {"err", "timed", "launches"}."""
    from audio_processor_tpu_torch.models import kda
    from audio_processor_tpu_torch.models import mla_decode as md
    from audio_processor_tpu_torch.models import moe_lm
    from audio_processor_tpu_torch.obs import profiler

    dev = torch.device(DEVICE)
    out: dict = {"err": {}, "timed": {}, "launches": {}}
    # 15a: prefill then kernel steps = the longer prefill; kernel = twin
    layer = _kda_layer(dev, seed + 71)
    R, T, n, layers = 8, 300, 4, 20
    H, D, W = layer.H, layer.D, layer.W
    gen = torch.Generator(device=dev).manual_seed(seed + 72)
    x = torch.randn(R, T + n, 2304, device=dev, generator=gen) \
        .to(torch.bfloat16)
    rows = [(r * T, T) for r in range(R)]
    rows_n = [(r * (T + n), T + n) for r in range(R)]

    def fresh():
        return (torch.zeros(R, H, D, D, device=dev),
                torch.zeros(R, 3, 3 * W, device=dev, dtype=torch.bfloat16))

    with torch.inference_mode():
        st, cv = fresh()
        layer.prefill(x[:, :T].flatten(0, 1), rows, st, cv)
        st2, cv2 = st.clone(), cv.clone()
        steps, plain = [], []
        for j in range(n):
            steps.append(layer.decode(x[:, T + j], st, cv))
            p = F.linear(x[:, T + j], layer.in_proj.weight)
            _, fg, _ = layer._split(p)
            plain.append(F.linear(kda.kda_decode_plain(
                p, fg, layer.conv_weight, layer.A_log, layer.dt_bias,
                layer.g_bias, layer.o_norm, layer.eps, st2, cv2),
                layer.o_proj.weight))
        want_st, want_cv = fresh()
        longer = layer.prefill(x.flatten(0, 1), rows_n, want_st, want_cv) \
            .view(R, T + n, -1)[:, T:]
    got = torch.stack(steps, 1).float()
    rel = float((got - longer.float()).norm() / longer.float().norm())
    srel = float((st - want_st).norm() / want_st.norm())
    assert rel < 2e-2 and srel < 1e-3, (rel, srel)
    torch.testing.assert_close(got, torch.stack(plain, 1).float(),
                               atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(st, st2, atol=1e-5, rtol=1e-5)
    assert torch.equal(cv, cv2) and torch.equal(cv, want_cv)
    out["err"]["kda"] = float((got - torch.stack(plain, 1).float()).abs()
                              .max())
    out["err"]["kda_vs_prefill_rel"] = rel
    out["err"]["kda_state_vs_prefill_rel"] = srel
    # us per launch over 20 layers' states (cold in L2, as in a step)
    states = torch.randn(layers, R, H, D, D, device=dev, generator=gen) \
        * 0.05
    convs = torch.randn(layers, R, 3, 3 * W, device=dev, generator=gen) \
        .to(torch.bfloat16)
    p = F.linear(x[:, T], layer.in_proj.weight)
    _, fg, _ = layer._split(p)
    args = (p, fg, layer.conv_weight, layer.A_log, layer.dt_bias,
            layer.g_bias, layer.o_norm, layer.eps)
    nbytes = (2 * 4 * R * H * D * D + 2 * R * 6 * W + 2 * R * H
              + 2 * 2 * R * 3 * 3 * W + 2 * (3 * W * 4 + W + D)
              + 4 * (H + W))
    with torch.inference_mode():
        us = 1e3 * _graph_ms(lambda: [kda.kda_decode(
            *args, states[i], convs[i]) for i in range(layers)], 20) / layers
        plain_us = 1e3 * _graph_ms(lambda: [kda.kda_decode_plain(
            *args, states[i], convs[i]) for i in range(layers)], 5) / layers
        kernels = _graph_kernels(lambda: [kda.kda_decode_plain(
            *args, states[i], convs[i]) for i in range(layers)]) / layers
    out["timed"]["kda"] = {"us": us, "plain_us": plain_us,
                           "plain_kernels_per_layer": kernels,
                           "bound_us": 1e6 * nbytes / 3.35e12,
                           "bytes": nbytes}
    del states, convs
    # 15d: the prefill kernel at the topics prompts' shapes
    out["err"]["kda_prefill"], out["timed"]["kda_prefill"] = \
        kda_prefill_check(layer, dev, gen)
    log(f"[15d] KDA prefill kernel vs twin, ms a layer beside the twin and "
        f"the bound: {json.dumps(out['err']['kda_prefill'])} "
        f"{json.dumps(out['timed']['kda_prefill'])}")
    del layer
    torch.cuda.empty_cache()
    # 15b: the MLA kernels at 32 heads, no rotation
    cfg = dataclasses.replace(moe_lm.MoELMConfig(), num_attention_heads=32,
                              num_key_value_heads=32, hidden_size=2304,
                              mla_use_nope=True)
    torch.manual_seed(seed + 73)
    attn = moe_lm.LatentAttention(cfg)
    with torch.no_grad():
        for name, prm in attn.named_parameters():
            if "layernorm" in name:
                prm.copy_(1 + 0.2 * torch.randn(prm.shape))
            else:
                prm.normal_(0.0, 0.04 if "kv_a" not in name else 0.02)
    attn = attn.to(dev).to(torch.bfloat16).eval().requires_grad_(False)
    mla_layers, nh = 7, 32
    buf = torch.randn(mla_layers, R, 8192, cfg.latent_dim, device=dev,
                      generator=gen).to(torch.bfloat16)
    slots = torch.arange(8192, device=dev)
    norm = attn.kv_a_layernorm
    w_k = attn.kv_b_proj.weight.unflatten(0, (nh, -1))[
        :, :cfg.qk_nope_head_dim]
    errs = []
    for cap, lo, hi in ((1536, 1270, 1470), (4096, 3890, 4000)):
        pos = torch.randint(lo, hi, (R,), device=dev, generator=gen)
        visible = slots[None, :cap] <= pos[:, None]
        xq = torch.randn(R, cfg.hidden_size, device=dev, generator=gen) \
            .to(torch.bfloat16)
        with torch.inference_mode():
            q, kv = attn.q_proj(xq), attn.kv_a_proj_with_mqa(xq)
            zeros = torch.zeros(R, 64, device=dev)
            cache = buf[0, :, :cap]
            plain_cache = cache.clone()
            pargs = (q, kv, zeros, zeros, norm.weight, norm.eps)
            got = md.mla_decode_prep(*pargs, cache, pos, nh, False)
            want = md.mla_decode_prep_plain(*pargs, plain_cache, pos, nh,
                                            False)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            cache.copy_(plain_cache)
            q_lat = torch.bmm(got[0], w_k)
            o = md.mla_decode_attention(q_lat, got[1], cache, visible,
                                        attn.scale)
            pl = md.mla_decode_attention_plain(q_lat, got[1], cache, visible,
                                               attn.scale)
            torch.testing.assert_close(o.float(), pl.float(), atol=1e-2,
                                       rtol=1e-2)
            errs.append(float((o.float() - pl.float()).abs().max()))
        if cap != 1536:
            continue
        nbytes = int((pos + 1).sum()) * cfg.latent_dim * 2 \
            + 2 * R * nh * (2 * cfg.kv_lora_rank + 64) + R * cap
        with torch.inference_mode():
            us = 1e3 * _graph_ms(lambda: [md.mla_decode_attention(
                q_lat, got[1], buf[i, :, :cap], visible, attn.scale)
                for i in range(mla_layers)], 20) / mla_layers
            plain_us = 1e3 * _graph_ms(lambda: [
                md.mla_decode_attention_plain(
                    q_lat, got[1], buf[i, :, :cap], visible, attn.scale)
                for i in range(mla_layers)], 5) / mla_layers
            library = _mla_library_us(q_lat, got[1], buf[:, :, :cap],
                                      visible, attn.scale)
        out["timed"]["mla32"] = {"us": us, "plain_us": plain_us,
                                 "library_us": library,
                                 "bound_us": 1e6 * nbytes / 3.35e12,
                                 "bytes": nbytes}
    out["err"]["mla32"] = max(errs)
    del buf, attn
    torch.cuda.empty_cache()
    # 15c: a graph-replayed generate of the 27-layer hybrid, 8 experts held
    spec = json.loads(Path("benchmark_torch/configs/"
                           "kimi-linear-48b-a3b.topics.json").read_text())
    small = moe_lm.MoELMConfig.from_dict(dict(spec, num_experts=8))
    lm = moe_lm.build_synthetic(small, dev, seed + 74, torch.bfloat16) \
        .requires_grad_(False)
    prompts = [torch.randint(0, 160000, (L,), generator=torch.Generator()
                             .manual_seed(seed + L)).tolist()
               for L in (300, 371, 129, 64, 65, 200, 333, 250)]
    _reset_launches()
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        t0 = time.perf_counter()
        with torch.inference_mode():
            for _ in range(2):
                lm.generate(prompts, 9)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        graphs = [s for s in profiler.spans() if s.id not in seen
                  and s.name == "topics.graph"]
    assert [s.attrs["mode"] for s in graphs] == ["capture", "replay"], graphs
    for s in graphs:
        assert s.attrs["kda_launches"] == 20 * s.attrs["steps"], s.attrs
        assert s.attrs["mla_launches"] == 7 * s.attrs["steps"], s.attrs
    out["launches"] = {"kda": kda.kda_decode.launches,
                       "kda_prefill": kda.kda_prefill.launches,
                       "mla32": md.mla_decode_attention.launches}
    assert out["launches"]["kda"] == 20 * 16, out["launches"]
    assert out["launches"]["kda_prefill"] == 20 * 2, out["launches"]
    log(f"[15] KDA decode kernel vs twin and prefill, MLA at 32 heads NoPE "
        f"vs plain: {json.dumps(out['err'])}")
    log(f"[15] us per launch over 20 KDA / 7 MLA layers (bound: bytes / "
        f"3.35 TB/s): {json.dumps(out['timed'])}; 2 generates of 8 rows x "
        f"9 tokens {wall:.2f} s, launches {out['launches']}; {smi_line()}")
    del lm
    torch.cuda.empty_cache()
    return out


def topics_phase(seed: int) -> dict:
    """Phase 14: the topic LM (``models/moe_lm.py``) at Moonlight-16B-A3B's
    published widths (seeded stand-in weights, bf16, 15.96 B parameters)
    as the local topic backend: one analysis batch of the topics cell (8
    calls of the cell's transcripts, its 48-topic glossary, 200 summary and
    3 class tokens) through ``TopicClassifier.infer_batch`` twice (the
    step graphs captured, then replayed), every call answered by both
    passes (no stand-in such as ``FAILED``, both prompts tapped); the first
    token and two decode steps of each prompt against the plain fp32
    reference (``benchmark_torch/reference/moonlight.py``, the program's
    bf16 parameters read one layer at a time), with the expert choices and
    their ties; the replays per loop and the kernels one replayed step
    launches (a ``torch.profiler`` window around one replay); ms per
    prefill, per step and per batch, and the peak device memory."""
    from benchmark_torch.harness import batch_topics as bt
    from benchmark_torch.reference import moonlight as ref_lm
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.host import topics
    from audio_processor_tpu_torch.host.topics import TopicClassifier
    from audio_processor_tpu_torch.models import moe_lm
    from audio_processor_tpu_torch.obs import profiler

    stand_ins = (topics.FAILED, topics.CONFIG_ERROR, topics.NOT_AVAILABLE)
    dev = torch.device(DEVICE)
    cell = json.loads(Path("benchmark_torch/configs/"
                           "moonlight-16b-a3b.topics.json").read_text())
    torch.cuda.reset_peak_memory_stats(dev)
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        gloss = Path(tmp) / "glossaire.xlsx"
        bt.write_xlsx(gloss, "explication",
                      bt.glossary_rows(cell["analyzers"]))
        cfg = PipelineConfig.from_dict(dict(
            cell["pipeline"], topics_glossary_b2c=str(gloss)))
        t0 = time.perf_counter()
        tc = TopicClassifier(cfg, device=dev)
        torch.cuda.synchronize()
        model = tc.local.model
        n = sum(p.numel() for p in model.parameters())
        log(f"[14] topic LM at published widths: {n / 1e9:.3f} B "
            f"parameters, {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
            f"on the card, drawn in {time.perf_counter() - t0:.1f} s")
        assert tc.enabled and abs(n - 15.96e9) < 0.01e9
        words = " ".join(cell["analyzers"]["phrases"]).split()
        per = bt.chunk_words(types.SimpleNamespace(config=cell), 8)
        texts = []
        for c in range(8):
            parts = []
            for k in range(8):
                share = 1.0 if k < 7 else 12.0 / 25.0
                start = (c * 13 + k * 5) % len(words)
                parts.append(" ".join(
                    words[(start + i) % len(words)]
                    for i in range(int(round(per[c, k] * share)))))
            texts.append("".join(parts))
        tap_steps = {"summary": [1, 199], "class": [1, 2]}
        model.tap = lambda kind, rows, steps: tap_steps[kind]
        runs = []
        _reset_launches()
        for i in range(2):
            with profiler.recording_spans():
                seen = {s.id for s in profiler.spans()}
                model.tapped = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                answers = tc.infer_batch(texts, ["B2C"] * 8)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = [s for s in profiler.spans() if s.id not in seen]
            assert len(answers) == 8 and all(
                a[1] and a not in stand_ins for a in answers), answers
            assert set(model.tapped) == {"summary", "class"}, model.tapped
            runs.append((wall, got, dict(model.tapped)))
            span = {k: [s for s in got if s.name == k] for k in (
                "topics.prefill", "topics.decode", "topics.graph")}
            log(f"[14] infer_batch {i}: {wall:.3f} s; "
                + "; ".join(f"{s.attrs['kind']} prefill {s.attrs['rows']} "
                            f"rows {s.attrs['tokens']} tokens "
                            f"{(s.t1 - s.t0) / 1e6:.1f} ms"
                            for s in span["topics.prefill"]) + "; "
                + "; ".join(f"{s.attrs['kind']} decode {s.attrs['steps']} "
                            f"steps {(s.t1 - s.t0) / 1e6:.1f} ms, experts "
                            f"touched {s.attrs['experts_touched']}"
                            for s in span["topics.decode"]) + "; graph "
                + ", ".join(f"{s.attrs['mode']} @{s.attrs['capacity']}"
                            for s in span["topics.graph"]))
            want = "replay" if i else None
            if want:
                assert all(s.attrs["mode"] == "replay"
                           for s in span["topics.graph"]), span
            layers = model.cfg.num_hidden_layers
            assert all(s.attrs["mla_launches"] == layers * s.attrs["steps"]
                       for s in span["topics.graph"]), span
            out["mla_launches"] = out.get("mla_launches", 0) + sum(
                s.attrs["mla_launches"] for s in span["topics.graph"])
        # both MLA kernels once a layer and step, as the spans count, and
        # no other kernel of csrc/ (the prefill runs SDPA)
        out["launches"] = _launches()
        counts = dict(out["launches"])
        assert counts.pop("mla_decode_prep") == counts.pop(
            "mla_decode_attention") == out["mla_launches"] > 0, out
        assert not any(counts.values()), counts
        model.tap = None
        wall, got, tapped = runs[1]
        out["batch_s"] = wall
        out["answers"] = [list(a) for a in answers]
        # one replayed step under the profiler
        st = next(iter(model._graphs.on(
            model.embed_tokens.weight.device,
            moe_lm.cuda_graphs.storage_key(model)).entries.values()))
        cap = max(st.graphs)
        g = st.graphs[cap]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            st.dg.replay(g)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        card_us = sum(e.device_time for e in kernels)
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        starts[0].record()
        for _ in range(20):
            st.dg.replay(g)
        starts[1].record()
        torch.cuda.synchronize()
        step_ms = starts[0].elapsed_time(starts[1]) / 20
        log(f"[14] one replayed step at capacity {cap}: {len(kernels)} "
            f"kernels, {card_us / 1e3:.3f} card ms in the profiler, "
            f"{step_ms:.3f} ms per replay back to back")
        out.update(step_ms=step_ms, kernels_per_step=len(kernels))
        # the reference, one layer at a time over the program's parameters
        seqs, at, hints, prog = [], [], [], []
        for kind, t in tapped.items():
            steps = sorted(t["steps"])
            last = max(steps)
            start = 0
            for r, p in enumerate(t["prompts"][:2]):
                L = len(p)
                seqs.append(list(p) + t["ids"][r, :last].tolist())
                at.append([L - 1] + [L - 1 + s for s in steps])
                pre = t["prefill_routes"][:, start:start + L]
                dec = t["decode_routes"][:last, :, r].transpose(0, 1)
                hints.append({layer: torch.cat([pre[j], dec[j]]).long()
                              for j, layer in enumerate(
                                  model.cfg.moe_layers)})
                prog.append(torch.stack([t["first_logits"][r]] + [
                    t["steps"][s][r] for s in steps]))
                start += L
        t0 = time.perf_counter()
        with torch.inference_mode():
            r = ref_lm.forward(ref_lm.layer_params(model.state_dict(), dev),
                               vars(model.cfg), seqs, at, hints,
                               bt.ROUTE_TIE_TOL, device=dev)
        err = sum(float((p.double() - q.double().cpu()).pow(2).sum())
                  for p, q in zip(prog, r["logits"]))
        ref_sq = sum(float(q.double().pow(2).sum()) for q in r["logits"])
        out.update(logit_rel_mse=err / ref_sq, route_ties=r["route_ties"],
                   route_mismatch=r["route_mismatch"],
                   peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        log(f"[14] reference over {len(seqs)} sequences "
            f"({sum(map(len, seqs))} tokens) in "
            f"{time.perf_counter() - t0:.1f} s: logit_rel_mse "
            f"{out['logit_rel_mse']:.3e}, route ties {r['route_ties']}, "
            f"mismatches {r['route_mismatch']}; peak "
            f"{out['peak_gb']:.2f} GB; {smi_line()}")
        assert out["logit_rel_mse"] < 1e-3 and not r["route_mismatch"]
    del tc, model, st, g
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("s2t", "ln", "topics", "mla", "kimi"),
                    help="run the card check, the build and this phase "
                         "alone")
    ap.add_argument("--rank-worker", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--spec", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_worker:
        return rank_worker(args.rank_worker, args.rank, args.world,
                           json.loads(args.spec))
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    name = card()
    build()
    if args.only:
        if args.only == "s2t":
            s2t_phase(args.seed)
        elif args.only == "topics":
            mla_decode_check(args.seed)
            topics_phase(args.seed)
        elif args.only == "mla":
            mla_decode_check(args.seed)
        elif args.only == "kimi":
            kimi_phase(args.seed)
        else:
            add_layer_norm_check(args.seed)
            graph_vs_eager(args.seed)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    rel = kernel_vs_plain(args.seed)
    flash = flash_vs_plain(args.seed)
    parts = parts_vs_plain(args.seed)
    graph_vs_eager(args.seed)
    fused_ln = add_layer_norm_check(args.seed)
    small_reference(args.seed, "auto")
    small_reference(args.seed, "flash")
    message_reference(args.seed, "auto", profile=True)
    message_reference(args.seed, "flash", profile=False)
    serving_reference(args.seed)
    train_reference(args.seed)
    rel.update(main_path(args.seed, "auto", 8, 3))
    flash.update(main_path(args.seed, "flash", 4, 1))
    assert rel["other"] == 0 and flash["other"] == 0
    ablation = ablation_path(args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        prod = production(args.seed, Path(tmp))
        text_card_vs_cpu(prod["models"], prod["rows"])
        int8 = int8_phase(args.seed, Path(tmp), prod["models"],
                          prod["engine"])
        models = prod["models"]
        del prod
        message = message_path(args.seed, Path(tmp) / "run8")
        served = serving_path(args.seed, models)
        tuned = finetune_path(args.seed, Path(tmp) / "run10", models)
        # Phase 11: free this process's models of phases 5-10 first.
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        log(f"[11] card memory held by this process before the ranks: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; "
            f"{smi_line()}")
        multi = multi_process_batch(args.seed, Path(tmp) / "run11a", rel)
        replicas = replica_engine(args.seed, Path(tmp) / "run11a")
        ddp_zero1(args.seed, Path(tmp) / "run11c", models,
                  Path(tmp) / "run10" / "data" / "train.jsonl")
        sharded_strategies(args.seed, Path(tmp) / "run11d")
        entered = entry_points()
        device_resample(args.seed)
    acoustic_heads(args.seed)
    s2t = s2t_phase(args.seed)["decode_attention"]
    mla = mla_decode_check(args.seed)
    lm = topics_phase(args.seed)
    kimi = kimi_phase(args.seed)
    assert int8["launches"] > 0
    assert "jax" not in sys.modules
    assert not any(m.split(".")[0] == "audio_processor_tpu"
                   for m in sys.modules), "the JAX package was imported"

    src = "audio_processor_tpu_torch/csrc/"
    tool = "tools/profile_kernel_parts.py"

    def row(name, source, replaces, launches, rec, by_path=None):
        bound_ms, bound_by = rec["bound"]
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                **({"launches_by_path": by_path} if by_path else {}),
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": rec["library_ms"]}

    def parts_row(name, modes, timed, replaces):
        ms, plain_ms = parts["times"][timed]
        rec = {"max_abs_err": max(parts["max_abs_err"][m] for m in modes),
               "ms": ms, "plain_ms": plain_ms,
               "library_ms": parts["library"][timed],
               "bound": parts["bounds"]["bare" if name == "bare" else "rel"]}
        return row(f"flash_rel_parts.{name}", "flash_rel_parts.cu",
                   replaces, ablation["launches"][name], rec)

    from audio_processor_tpu_torch.models.flash_rel_parts import (
        VARIANT_MODES,
    )

    # flash_rel runs on the batch path (phase 5), the message path (phase
    # 8, fused and mono dispatches), the server (phase 9), the batch path
    # in 2 processes (11a), the 2-replica engine (11b) and entry() (11e);
    # fine-tuning (phase 10) runs the plain attention, 0.
    rel_paths = {"batch": rel["launches"], "message": message["launches"],
                 "serve": served["launches"],
                 "finetune": tuned["launches"]["flash_rel_attention"],
                 "multi_process": multi["launches"],
                 "replicas": replicas["launches"],
                 "entry": entered["launches"]}
    kernels = [
        row("flash_rel_attention (onepass)", "flash_rel_attention.cu",
            "audio_processor_tpu/models/flash_rel_attention.py:169",
            sum(rel_paths.values()), rel, rel_paths),
        row("flash_rel_attention (stream)", "flash_rel_attention.cu",
            "audio_processor_tpu/models/flash_rel_attention.py:73",
            sum(rel_paths.values()), rel, rel_paths),
        row("flash_attention", "flash_attention.cu",
            "audio_processor_tpu/models/wav2vec2bert.py:276",
            flash["launches"], flash),
        parts_row("kb640", ["kb640"], "kb640", f"{tool}:181"),
        parts_row("bare", ["bare:ones", "bare:reduce"], "bare:ones",
                  f"{tool}:134"),
        parts_row("variant", VARIANT_MODES, "full", f"{tool}:37"),
    ]
    for mode in ("cross", "self102"):
        t = s2t["timed"][mode]
        kernels.append(row(
            f"decode_attention ({mode})", "decode_attention.cu",
            "none: the JAX package has no text decoder", s2t["launches"],
            {"max_abs_err": max(s2t["max_abs_err"].values()),
             "ms": t["us"] / 1e3, "plain_ms": t["plain_us"] / 1e3,
             "bound": (t["bound_us"] / 1e3, "bytes"),
             "library_ms": t["library_us"] / 1e3}))
    # the fused LayerNorm's launches on the batch path (phases 5 and 5b),
    # each counted from 0 just before its run
    ln_paths = {"batch": rel["ln_launches"],
                "batch_flash": flash["ln_launches"]}
    t = fused_ln["timed"]["add_ln"]
    kernels.append(row(
        "add_layer_norm (add_ln)", "add_layer_norm.cu",
        "none: the JAX package's layer_norm is plain XLA",
        sum(ln_paths.values()),
        {"max_abs_err": max(w["max_abs_err"]
                            for w in fused_ln["worst"].values()),
         "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound": (t["bound_ms"], "bytes"),
         "library_ms": t["library_ms"]}, ln_paths))
    # the MLA kernels' launches on the topic LM (phase 14), counted from 0
    # just before its run
    for part, err in (("prep", "prep_latent."), ("attention", "attention.")):
        t = mla["timed"][part]
        kernels.append(row(
            f"mla_decode ({part})", "mla_decode.cu",
            "none: the JAX package has no LM",
            lm["launches"][f"mla_decode_{part}"],
            {"max_abs_err": max(v for k, v in mla["err"].items()
                                if k.startswith(err)),
             "ms": t["us"] / 1e3, "plain_ms": t["plain_us"] / 1e3,
             "bound": (t["bound_us"] / 1e3, "bytes"),
             "library_ms": None if t.get("library_us") is None
             else t["library_us"] / 1e3}))
    # the hybrid's kernels, counted over phase 15c's generate
    for name, part in (("kda_decode", "kda"),
                       ("mla_decode (attention, 32 heads, NoPE)", "mla32")):
        t = kimi["timed"][part]
        kernels.append(row(
            name, "kda_decode.cu" if part == "kda" else "mla_decode.cu",
            "none: the JAX package has no LM", kimi["launches"][part],
            {"max_abs_err": kimi["err"][part], "ms": t["us"] / 1e3,
             "plain_ms": t["plain_us"] / 1e3,
             "bound": (t["bound_us"] / 1e3, "bytes"),
             "library_ms": None if t.get("library_us") is None
             else t["library_us"] / 1e3}))
    t = kimi["timed"]["kda_prefill"][3960]
    kernels.append(row(
        "kda_prefill (8 x ~3,960 tokens)", "kda_prefill.cu",
        "none: the JAX package has no LM", kimi["launches"]["kda_prefill"],
        {"max_abs_err": max(e["out_max_abs"]
                            for e in kimi["err"]["kda_prefill"].values()),
         "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound": (t["bound_ms"], t["bound_by"]), "library_ms": None}))
    assert all(k["launches"] > 0 for k in kernels), kernels
    log(smi_line())            # again here, beside the numbers it qualifies
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
