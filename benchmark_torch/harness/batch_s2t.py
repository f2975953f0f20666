"""Driver of the speech-to-text batch cell: the program's ``DataProcessor``
sweeping a pool of calls through SeamlessM4T v2 speech-to-text
(``asr_model_type: seamless_m4t_v2_s2t``), as :mod:`.batch` does for the
CTC cells, whose window, sweeps, set-up and end-to-end metrics it shares.

Set-up adds to :mod:`.batch`'s: the whole speech-to-text path's weights
are drawn on the device from the seed (:func:`s2t_layout`, the program's
state-dict names; the decoder's attention wider, ``ATTENTION_SCALE``) and
the piece table is made from the seed
(:func:`pieces`); warming each (bucket, device batch) shape with
full-length chunks decodes to the bucket's largest cap, so every decoder
step graph is captured before the window.

The comparison (:func:`check_s2t`) takes a seeded sample of device batches
(``SAMPLE_TOP`` of the largest bucket, ``SAMPLE_OTHER`` of the others), and
in each a seeded subset of ``ROWS`` real rows and ``STEPS`` generated-token
steps. The program keeps the logits of those steps as it serves them
(``TextDecoder.tap_steps``). After the window, with the program freed, the
plain reference (``reference/seamless_s2t.py``, fp32, TF32 off, each row
alone) recomputes the adaptor output of the sampled rows and, teacher
forced on the tokens the program emitted, the decoder's logits at the
sampled steps. Logits are compared, never tokens:

- ``enc_out_rel_mse``: the adaptor output over the valid adaptor frames
  (sum of squared differences over the sum of squared reference values);
- ``logit_rel_mse``: the decoder logits at the sampled steps, the same way;
- ``served_not_argmax``: sampled steps whose served token is not the
  argmax of the program's own logits, the pad id excluded (exact);
- ``steps_mismatch``: rows of the sampled batches whose tokens break the
  rule: text tokens without ``</s>``, then ``</s>`` if the row stopped
  before its cap, then pad; the cap from the reference's adaptor frames
  (exact);
- ``frame_mismatch``: rows whose adaptor frames differ from the
  reference's (exact);
- ``text_mismatch``: sampled chunks whose persisted texts differ from the
  reference's detokenization of the tokens the program served (exact);
- ``rows_missing`` and ``feature_err_max``: as :mod:`.check`.
"""

from __future__ import annotations

import gc
import math
import random
import statistics
import threading
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from audio_processor_tpu_torch.models import seamless_s2t as s2t

from . import check, weights
from .batch import (
    Run, _end_to_end, _link_sweep, _pipeline_config, _pool_name,
    _profile_sweep, _read_csv, _shapes,
)
from .job import Job
from .spans import Recorder
from ..reference import acoustic as ref_ac
from ..reference import seamless_s2t as ref
from ..reference import w2v_bert as ref_w2v

SAMPLE_TOP = 2      # sampled device batches of the largest bucket
SAMPLE_OTHER = 1    # and of the other buckets
ROWS = 12           # sampled real rows per sampled device batch
STEPS = 4           # sampled generated-token steps per device batch
ENCODER_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads",
                "intermediate_size", "feature_projection_input_dim",
                "conv_depthwise_kernel_size", "left_max_position_embeddings",
                "right_max_position_embeddings", "layer_norm_eps")
SPECIAL = (0, 1, 2, 3)   # <pad> <unk> <s> </s>
# With every weight N(0, 0.02) the decoder's attention is near uniform and
# adds little to the logits, so a fault in the cache, the masks or the
# cross K/V would move them less than bf16 rounding does. Its query, value
# and output weights are drawn 4 times wider: peaked attention whose output
# weighs as much as the FFN's, as in a trained decoder.
ATTENTION_SCALE = 4.0
LETTERS = "ابتثجحخدذرزسشصضطظعغفقكلمنهويىءآأؤإئةّ" \
    "abcdefghijklmnopqrstuvwxyz0123456789"


def lang_id(job: Job) -> int:
    lang = job.config["pipeline"].get("s2t_tgt_lang_id")
    return job.config["model"]["vocab_size"] - 1 if lang is None \
        else int(lang)


def reader_model(m: Dict) -> Dict:
    """The speech encoder's keys under the names the CTC cells' readers
    read, with no CTC head (``vocab_size`` 0)."""
    return dict({k: m[k] for k in ENCODER_KEYS}, vocab_size=0)


def s2t_layout(m: Dict) -> weights.Layout:
    """Parameter names and shapes of the program's ``SeamlessS2T`` (HF's
    ``SeamlessM4Tv2ForSpeechToText`` modules under the port's names)."""
    h, f = m["hidden_size"], m["intermediate_size"]
    k = m["adaptor_kernel_size"]
    out = [(f"speech_encoder.{n}", s, kind) for n, s, kind in
           weights.w2v_bert_layout(dict(m, vocab_size=1))
           if not n.startswith("lm_head")]
    out += weights._ln("speech_encoder.layer_norm", h)
    for part, a, b in (("intermediate_dense", h, f), ("output_dense", f, h)):
        out += weights._linear(f"speech_encoder.intermediate_ffn.{part}", a, b)
    for i in range(m["num_adapter_layers"]):
        p = f"speech_encoder.adapter.{i}"
        for br in ("residual", "self_attn"):
            out += weights._ln(f"{p}.{br}_layer_norm", h)
            out += [(f"{p}.{br}_conv.weight", (2 * h, h, k), "normal"),
                    (f"{p}.{br}_conv.bias", (2 * h,), "zeros")]
        for n in ("q", "k", "v", "out"):
            out += weights._linear(f"{p}.self_attn.linear_{n}", h, h)
        out += weights._ln(f"{p}.ffn_layer_norm", h)
        out += weights._linear(f"{p}.ffn.intermediate_dense", h, f)
        out += weights._linear(f"{p}.ffn.output_dense", f, h)
    out += weights._ln("speech_encoder.inner_layer_norm", h)
    out.append(("text_decoder.embed_tokens.weight", (m["vocab_size"], h),
                "normal"))
    fd = m["decoder_ffn_dim"]
    for i in range(m["decoder_layers"]):
        p = f"text_decoder.layers.{i}"
        for att in ("self_attn", "cross_attention"):
            for n in ("q", "k", "v", "out"):
                out += weights._linear(f"{p}.{att}.{n}_proj", h, h)
            out += weights._ln(f"{p}.{att}_layer_norm", h)
        out += weights._linear(f"{p}.ffn.fc1", h, fd)
        out += weights._linear(f"{p}.ffn.fc2", fd, h)
        out += weights._ln(f"{p}.ffn_layer_norm", h)
    out += weights._ln("text_decoder.layer_norm", h)
    return out


def attention_scale(m: Dict) -> Dict[str, float]:
    """``ATTENTION_SCALE`` on the decoder's attention query, value and
    output weights, self and cross (see the module's notes)."""
    return {f"text_decoder.layers.{i}.{att}.{n}_proj.weight": ATTENTION_SCALE
            for i in range(m["decoder_layers"])
            for att in ("self_attn", "cross_attention")
            for n in ("q", "v", "out")}


def pieces(vocab_size: int, seed: int, lang: int) -> List[str]:
    """The benchmark's piece table: ids 0-3 ``<pad> <unk> <s> </s>``,
    ``lang`` ``__arb__``, every other id 1-6 of :data:`LETTERS`, a third
    of them starting a word (``▁``)."""
    rng = np.random.default_rng(int(seed))
    letters = np.asarray(list(LETTERS), dtype=object)
    lens = rng.integers(1, 7, size=vocab_size)
    starts = rng.random(vocab_size) < 1.0 / 3.0
    codes = letters[rng.integers(0, len(letters), size=int(lens.sum()))]
    ends = np.cumsum(lens)
    out = [(ref.WORD_START if s else "") + "".join(codes[e - n:e])
           for n, e, s in zip(lens, ends, starts)]
    out[:4] = ["<pad>", "<unk>", "<s>", "</s>"]
    out[lang] = "__arb__"
    return out


def _rule(job: Job) -> Dict:
    p = job.config["pipeline"]
    return {"a": float(p["s2t_len_a"]), "b": int(p["s2t_len_b"]),
            "max_new_tokens": int(p["s2t_max_new_tokens"])}


def build_engine(job: Job, dev, root: Path):
    """Kernels, the seeded weights in the program's ``SeamlessS2T``, the
    seeded piece table, and the ``ASREngine``: (engine, pipeline config,
    weight seed, pieces)."""
    from audio_processor_tpu_torch import _build
    from audio_processor_tpu_torch.models.pieces import PieceVocab
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine

    job.mark("import")
    if dev.type == "cuda":
        _build.build_all(("flash_rel_attention",), native=True)
    job.mark("kernels")
    m = job.config["model"]
    pcfg = _pipeline_config(job, root)
    w_seed = weights.sub_seed(job.seed, "s2t-weights")
    sd = weights.make(s2t_layout(m), w_seed, dev, attention_scale(m))
    rule = s2t.rule_from_config(pcfg)
    with torch.device("meta"):
        model = s2t.SeamlessS2T(s2t.S2TConfig.from_dict(m), rule)
    model.load_state_dict(sd, assign=True, strict=True)
    del sd
    lang = lang_id(job)
    table = pieces(m["vocab_size"], weights.sub_seed(job.seed, "pieces"),
                   lang)
    engine = ASREngine(pcfg, device=dev, model=model,
                       vocab=PieceVocab(table, list(SPECIAL) + [lang]))
    job.mark("weights")
    return engine, pcfg, w_seed, table


def capture_sample(job: Job, rec: Recorder, run: Run, engine) -> List[Dict]:
    """Wrap the engine's prep, dispatch, fused program, speech encoder,
    decoder and fetch: record every device batch (lengths; tokens each
    real row emitted, once fetched), have the decoder keep the logits of
    ``STEPS`` seeded steps, and keep a seeded reservoir of device batches
    with the adaptor output, frames, tokens, text masks, kept logits and
    acoustic features of ``ROWS`` seeded rows."""
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine

    pad = engine.model_cfg.pad_token_id
    dec = engine.model.text_decoder
    pending_prep: Dict[int, List[int]] = {}
    pending_out: Dict[int, tuple] = {}
    local = threading.local()
    rng = random.Random(weights.sub_seed(job.seed, "sample"))
    tap_rng = random.Random(weights.sub_seed(job.seed, "taps"))
    seen = {"top": 0, "other": 0}
    sample: Dict[str, List] = {"top": [], "other": []}
    taken: Dict[str, set] = {"top": set(), "other": set()}
    top_bucket = max(engine.bucket_samples)

    def tap_steps(steps):
        return tap_rng.sample(range(steps), min(STEPS, steps)) \
            if rec.on else ()

    dec.tap_steps = tap_steps

    def prep_after(out, args, kwargs, t0, t1):
        pending_prep[id(out[0])] = [int(x) for x in args[1].lengths]

    def encoder_after(out, args, kwargs, t0, t1):
        mask = args[2] if len(args) > 2 else kwargs["attention_mask"]
        local.enc = (out, args[0].output_mask(mask).sum(dim=1))

    def run_fused_after(out, args, kwargs, t0, t1):
        buf, bucket = args[1], args[3]
        real = pending_prep.pop(id(buf), None)
        enc = getattr(local, "enc", None)
        local.enc = None
        if real is None:
            return
        d = {"bucket": int(bucket), "n_dev": int(buf.shape[0]),
             "real": real, "t": t0, "emitted": None}
        run.dispatches.append(d)
        if run.tracing_window[0] is not None \
                and run.tracing_window[1] is None:
            run.traced_dispatches.append(d)
        key = "top" if int(bucket) == top_bucket else "other"
        k = SAMPLE_TOP if key == "top" else SAMPLE_OTHER
        seen[key] += 1                    # reservoir, decided here so
        n_held = len(sample[key]) + len(taken[key])   # only the sampled
        slot = n_held if n_held < k else rng.randrange(seen[key])   # keep
        held = None
        if slot < k and enc is not None and dec.tapped:
            taken[key].add(slot)
            rows = sorted(rng.sample(range(3 * len(real)),
                                     min(ROWS, 3 * len(real))))
            held = (key, slot, rows, enc, dict(dec.tapped))
        pending_out[id(out)] = (d, held)

    def fetch_after(out, args, kwargs, t0, t1):
        for sub_chunks, dev_out, err in args[2]:
            d, held = pending_out.pop(id(dev_out), (None, None))
            if d is None:
                continue
            n = len(sub_chunks)
            if held is not None:
                taken[held[0]].discard(held[1])
            if err is not None:
                continue
            ids, text, af = (np.concatenate([p[i].cpu().numpy()
                                             for p in dev_out])
                             for i in range(3))
            d["emitted"] = (ids[:3 * n] != pad).sum(axis=1).tolist()
            if held is None:
                continue
            key, slot, rows, (enc, frames), tapped = held
            sel = torch.tensor(rows, device=enc.device)
            item = {"bucket": d["bucket"], "lengths": d["real"],
                    "chunks": [(c.file_name, c.chunk_idx, c.start_time,
                                c.end_time) for c in sub_chunks],
                    "ids": ids[:3 * n], "text": text[:3 * n].astype(bool),
                    "af": af[:n], "rows": rows,
                    "frames": frames[:3 * n].cpu().numpy(),
                    "enc": enc[sel].float().cpu().numpy(),
                    "logits": {g: lg[sel].float().cpu().numpy()
                               for g, lg in tapped.items()}}
            if slot < len(sample[key]):
                sample[key][slot] = item
            else:
                sample[key].append(item)

    E = ASREngine
    rec.wrap(E, "_prepare_fused_buffer", "asr_engine.prep", after=prep_after)
    rec.wrap(E, "_run_fused", "asr_engine.dispatch", after=run_fused_after)
    rec.wrap(E, "_fused", "asr_fused")
    rec.wrap(s2t.SpeechEncoder, "forward", "encoder", after=encoder_after)
    rec.wrap(s2t.TextDecoder, "cross_kv", "decoder.cross_kv")
    rec.wrap(s2t.TextDecoder, "decode", "decoder.loop")
    rec.wrap(E, "_fetch_pending", "asr_engine.fetch", after=fetch_after)
    return sample


def run(job: Job) -> Dict:
    """One run of the speech-to-text cell; returns the result object."""
    dev = torch.device(job.device)
    cuda = dev.type == "cuda"
    from audio_processor_tpu_torch.pipeline import engine as engine_mod
    from audio_processor_tpu_torch.pipeline.batching import (
        create_file_batches,
    )
    from audio_processor_tpu_torch.pipeline.chunker import Chunk

    m = job.config["model"]
    root = job.tmp
    rec = Recorder()
    runrec = Run(job, rec, reader_model(m))

    # ---- set-up ------------------------------------------------------
    engine, pcfg, w_seed, table = build_engine(job, dev, root)
    pool = job.generator.make_pool(job.mix, weights.sub_seed(
        job.seed, "traffic"), root / "pool", dev)
    job.mark("pool")
    by_name = {p["name"]: p for p in pool}
    batches = create_file_batches(
        [p["path"] for p in pool], float(pcfg.max_batch_size_mb),
        int(pcfg.file_batch_size))
    names_per_batch = [[Path(f).name for f in b] for b in batches]
    shapes = _shapes(engine, pool, names_per_batch, pcfg)
    for bucket, n in sorted(shapes):
        zeros = np.zeros(bucket, np.float32)
        engine.transcribe_chunks([Chunk("warmup.wav", i, 0.0, 0.0,
                                        agent=zeros, client=zeros)
                                  for i in range(n)])
    proc = engine_mod.DataProcessor(pcfg, device=dev, asr_engine=engine)
    proc.setup_models()
    smallest = min(names_per_batch, key=len)
    proc.process_files_parallel(
        _link_sweep(pool, root / "in" / "warm", "warm", smallest))
    if cuda:
        torch.cuda.synchronize()

    # ---- spans, counters and the sample for the comparison -----------
    starts: Dict[str, float] = {}
    done: Dict[str, float] = {}
    failed_calls: set = set()

    def decode_before(args, kwargs):
        t = time.perf_counter()
        for f in args[1]:
            starts.setdefault(Path(f).name, t)

    def decode_after(out, args, kwargs, t0, t1):
        runrec.decoded_audio_s += sum(
            by_name[_pool_name(Path(f).name)]["duration_s"] for f in args[1])

    def analysis_after(out, args, kwargs, t0, t1):
        ctx = args[1]
        for d in ctx["decoded"]:
            nm = d["file"].name
            if str(d["file"]) in ctx["batch_failed"] or not out:
                failed_calls.add(nm)
            else:
                done[nm] = t1
        runrec.analysed_audio_s += sum(
            by_name[_pool_name(d["file"].name)]["duration_s"]
            for d in ctx["decoded"])

    D = engine_mod.DataProcessor
    rec.wrap(D, "_decode_batch", "engine.decode", decode_before, decode_after)
    rec.wrap(D, "_analysis_stage", "engine.analysis", after=analysis_after)
    sample = capture_sample(job, rec, runrec, engine)

    job.mark("warm-up")
    setup_s = time.perf_counter() - job.t_process
    job.say(f"[setup] phases: {job.phases()}")
    job.say(f"[setup] {setup_s:.3f} s; pool {len(pool)} calls, "
            f"{sum(p['duration_s'] for p in pool):.1f} audio s; file batches "
            f"{[len(b) for b in batches]}; shapes warmed {sorted(shapes)}")

    # ---- window ------------------------------------------------------
    attempted: List[str] = []
    try:
        rec.on = True
        t_start = time.perf_counter()
        k = 0
        while True:
            files = _link_sweep(pool, root / "in" / f"s{k:04d}", f"s{k:04d}")
            attempted += [f.name for f in files]
            if job.trace and k == 0:
                _profile_sweep(proc, files, rec, runrec.tracing_window, cuda,
                               runrec)
            else:
                proc.process_files_parallel(files)
            k += 1
            if time.perf_counter() - t_start >= job.seconds:
                break
        t_end = time.perf_counter()
        rec.on = False
    finally:
        rec.restore()
        engine.model.text_decoder.tap_steps = None
    window_s = t_end - t_start
    runrec.window_s = window_s
    completed = [nm for nm in attempted if nm in done
                 and nm not in failed_calls]
    runrec.audio_s = sum(by_name[_pool_name(nm)]["duration_s"]
                         for nm in completed)
    latencies = [done[nm] - starts[nm] for nm in completed if nm in starts]
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    job.say(f"[window] {window_s:.3f} s, {k} sweeps, calls attempted "
            f"{len(attempted)}, completed {len(completed)}, audio "
            f"{runrec.audio_s:.1f} s, device batches "
            f"{len(runrec.dispatches)}")

    # ---- the program's outputs, then its state freed ------------------
    proc.close()
    rows = _read_csv(root / "out")
    del proc, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = check_s2t(job, m, sample["top"] + sample["other"], by_name,
                       attempted, rows, pcfg, dev, w_seed, table)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    # ---- metrics -----------------------------------------------------
    metrics: Dict[str, Dict] = {}
    if not job.trace:
        for e in job.end_to_end:
            v = _end_to_end(e["name"], setup_s, window_s, runrec, latencies)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    else:
        for mt, reader in job.per_layer:
            v = reader.read(runrec)
            if v is not None:
                metrics[mt["name"]] = {"value": v, "unit": mt["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": len(attempted),
              "failed": len(attempted) - len(completed), "metrics": metrics,
              "device": device}
    if job.trace and runrec.trace is not None:
        t = runrec.trace
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.idle_gaps()}
    if len(latencies) >= 2:
        q = statistics.quantiles(latencies, n=10)
        job.say(f"[latency] calls {len(latencies)}, p50 "
                f"{statistics.median(latencies):.4f} s, p90 {q[8]:.4f} s, "
                f"max {max(latencies):.4f} s")
    result["checks"] = checks
    return result


def _rule_breaks(ids: np.ndarray, text: np.ndarray, cap: int, pad: int,
                 eos: int) -> bool:
    """Whether one row's tokens break the ``</s>``/cap rule."""
    n = int(text.sum())
    if not text[:n].all() or n > cap or (ids[:n] == eos).any():
        return True
    end = n
    if n < cap:                      # stopped early: on </s>
        if n >= len(ids) or ids[n] != eos:
            return True
        end = n + 1
    return bool((ids[end:] != pad).any())


def check_s2t(job: Job, m: Dict, sample: List[Dict], pool: Dict,
              attempted: List[str], rows: Dict, pcfg, device, w_seed: int,
              table: List[str]) -> Dict:
    t0 = time.perf_counter()
    lim = job.limits
    out: Dict[str, Dict] = {}
    entry = check._entry

    missing = 0
    for nm in attempted:
        p = pool[_pool_name(nm)]
        want = check.expected_chunks(p["samples"], p["sample_rate"], pcfg)
        ok = sum(1 for r in rows.get(nm, []) if not r.get("error"))
        missing += abs(want - ok)
    out["rows_missing"] = entry(missing, lim["rows_missing"])

    w = weights.make(s2t_layout(m), w_seed, device, attention_scale(m))
    sr = int(pcfg.target_sample_rate)
    rule = _rule(job)
    lang = lang_id(job)
    pad, eos = m["pad_token_id"], m["eos_token_id"]
    special = set(SPECIAL) | {lang}
    cache: Dict = {}
    read_pcm = job.generator.read_pcm
    text_bad = frame_bad = steps_bad = 0
    feats_p, feats_r, feats_c = [], [], []
    work = []   # (wave, program adaptor output, ids, {step: logits})
    for item in sample:
        for j, (fname, cidx, ts, te) in enumerate(item["chunks"]):
            src = check._source_rows(pool[_pool_name(fname)], ts, te, cache,
                                     read_pcm, sr)
            a, c = src[0], src[1]
            views = [(a.float() + c.float()) * 0.5, a.float(), c.float()]
            n_smp = int(item["lengths"][j])
            frames = ref.adaptor_frames(ref.encoder_frames(n_smp),
                                        m["adaptor_stride"])
            cap = ref.cap(frames, rule["a"], rule["b"],
                          rule["max_new_tokens"])
            texts = []
            for v in range(3):
                r = 3 * j + v
                ids, txt = item["ids"][r], item["text"][r]
                texts.append(ref.detokenize(ids[txt], table, special))
                steps_bad += _rule_breaks(ids, txt, cap, pad, eos)
                if int(item["frames"][r]) != frames:
                    frame_bad += 1
                    continue
                if r in item["rows"]:
                    k = item["rows"].index(r)
                    work.append((views[v], item["enc"][k, :frames], ids,
                                 {g: lg[k] for g, lg in
                                  item["logits"].items()}))
            file_rows = rows.get(fname, [])
            if cidx >= len(file_rows) or any(
                    file_rows[cidx][f] != t
                    for f, t in zip(check.TEXT_FIELDS, texts)):
                text_bad += 1
            with ref_w2v.no_tf32():
                for s, wave in ((0, a), (1, c)):
                    feats_p.append(item["af"][j, s].astype(np.float64))
                    feats_r.append(ref_ac.features(
                        wave.float().to(device)).numpy())
                    if job.control:
                        feats_c.append(ref_ac.features(
                            wave.float().to(device),
                            dtype=torch.bfloat16).numpy())
    out["text_mismatch"] = entry(text_bad, lim["text_mismatch"])
    out["frame_mismatch"] = entry(frame_bad, lim["frame_mismatch"])
    out["steps_mismatch"] = entry(steps_bad, lim["steps_mismatch"])
    if feats_p:
        P, R = np.stack(feats_p), np.stack(feats_r)
        out["feature_err_max"] = entry(check.feature_err(P, R),
                                       lim["feature_err_max"])
        if job.control:
            job.readings["feature_err_max.bf16_reference"] = \
                check.feature_err(np.stack(feats_c), R)

    enc_sq = enc_ref = lg_sq = lg_ref = 0.0
    not_argmax = compared = 0
    start = m["decoder_start_token_id"]
    groups: Dict[tuple, list] = {}
    for wave, enc_p, ids, taps in work:
        groups.setdefault((wave.shape[0], tuple(sorted(taps))), []) \
            .append((wave, enc_p, ids, taps))
    with torch.inference_mode():
        for (_, steps), items in groups.items():
            for i in range(0, len(items), check.BLOCK_ROWS):
                blk = items[i:i + check.BLOCK_ROWS]
                feats = torch.stack([ref_w2v.fbank(wv.to(device))
                                     for wv, _, _, _ in blk])
                enc = ref.speech_encoder(w, m, feats)
                ep = torch.from_numpy(np.stack([e for _, e, _, _ in blk])) \
                    .to(device).double()
                enc_sq += float((ep - enc.double()).pow(2).sum())
                enc_ref += float(enc.double().pow(2).sum())
                if not steps:
                    continue
                T = max(steps) + 1
                toks = torch.tensor(
                    [[start, lang] + [int(t) for t in ids[:T - 1]]
                     for _, _, ids, _ in blk], device=device)
                lg = ref.decoder_logits(w, m, enc, toks,
                                        at=[g + 1 for g in steps])
                pl = torch.from_numpy(np.stack(
                    [np.stack([taps[g] for g in steps])
                     for _, _, _, taps in blk])).to(device).double()
                served = torch.tensor([[int(ids[g]) for g in steps]
                                       for _, _, ids, _ in blk],
                                      device=device)
                live = served != pad          # steps the row decoded
                keep = live[..., None].double()
                lg_sq += float(((pl - lg.double()) * keep).pow(2).sum())
                lg_ref += float((lg.double() * keep).pow(2).sum())
                best = pl[..., 1:].argmax(-1) + 1 if pad == 0 else \
                    pl.index_fill(-1, torch.tensor([pad], device=device),
                                  -math.inf).argmax(-1)
                not_argmax += int(((best != served) & live).sum())
                compared += int(live.sum())
                del lg, enc, feats
    # nothing compared is no evidence: it fails
    out["enc_out_rel_mse"] = entry(enc_sq / enc_ref if enc_ref > 0
                                   else math.inf, lim["enc_out_rel_mse"])
    out["logit_rel_mse"] = entry(lg_sq / lg_ref if lg_ref > 0 else math.inf,
                                 lim["logit_rel_mse"])
    out["served_not_argmax"] = entry(not_argmax if compared else math.inf,
                                     lim["served_not_argmax"])
    del w
    job.say(f"[check] {len(sample)} device batches, {len(work)} rows, "
            f"{compared} steps, {len(feats_p)} feature rows, reference "
            f"{time.perf_counter() - t0:.2f} s")
    for v in out.values():
        if not math.isfinite(v["value"]):   # JSON has no infinity
            v["value"] = 1e30
    return out
