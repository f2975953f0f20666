"""The comparison that decides ``correct``: what the window produced, set
against the plain reference (``benchmark_torch/reference/``) on the same
audio and on weights the benchmark draws again from the same seed.

Numbers compared (each with its limit from ``limits/<cell>.json``):

- ``logit_rel_mse``: the CTC logits the program computed for every valid
  frame of every row (mixed, agent, client) of the sampled device batches,
  against the reference's: the sum of squared differences over the sum of
  squared reference logits. It covers the fbank frontend, all encoder
  layers with the attention kernel and the CTC head. The widest and the
  mean gap by which a served id's reference logit lies below the
  reference's best are kept as readings: they do not separate the
  configured bf16 from the int8 control by the factor a limit needs
  (PERF.md);
- ``served_not_argmax``: frames whose served greedy id is not the argmax of
  the program's own logits (exact);
- ``frame_mismatch``: rows whose count of valid frames differs from the
  reference's (exact);
- ``text_mismatch``: sampled chunks whose persisted transcripts differ from
  the reference's decoding of the ids the program served (exact);
- ``feature_err_max``: the widest error of the fused acoustic features,
  relative to the largest magnitude of that feature over the sample;
- ``rows_missing``: chunks of calls attempted in the window without a
  persisted row free of error (exact);
- with text classifiers (:mod:`.prod`): their probabilities, the heads'
  probabilities and the fusion labels, and one database row per chunk.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from . import weights
from ..reference import acoustic as ref_ac
from ..reference import w2v_bert as ref

BLOCK_ROWS = 12
TEXT_FIELDS = ("transcription_chunk", "agent_transcription",
               "client_transcription")


def _entry(value, limit) -> Dict:
    return {"value": float(value), "limit": float(limit)}


def expected_chunks(n_samples: int, rate: int, pcfg) -> int:
    """Chunks of a call of ``n_samples`` at ``rate`` after resampling to the
    pipeline's rate: 25 s windows every 24 s until one reaches the end."""
    sr = int(pcfg.target_sample_rate)
    n = -(-n_samples * sr // rate)
    chunk = int(pcfg.chunk_duration_sec * sr)
    step = chunk - int(pcfg.overlap_sec * sr)
    if n <= 0:
        return 0
    return 1 if n <= chunk else 1 + -(-(n - chunk) // step)


def _source_rows(pool_entry: Dict, start_s: float, end_s: float,
                 cache: Dict, read_pcm, target_sr: int) -> torch.Tensor:
    """[2, n] float64 agent / client audio of one chunk, full scale 1."""
    key = pool_entry["name"]
    if key not in cache:
        x, rate = read_pcm(pool_entry["path"])
        x = torch.from_numpy(x / 32768.0)
        if rate != target_sr:
            # resampled, then on the int16 wire as the pipeline documents
            from ..reference.resample import resample
            x = torch.round(resample(x, rate, target_sr) * 32768.0) \
                .clamp(-32768, 32767) / 32768.0
        if len(cache) >= 8:
            cache.pop(next(iter(cache)))
        cache[key] = x
    x = cache[key]
    s, e = round(start_s * target_sr), round(end_s * target_sr)
    return x[:, s:e]


def batch(job, m: Dict, vocab_list: List[str], sample: List[Dict],
          pool: Dict, attempted: List[str], rows: Dict, pcfg, device,
          w_seed: int, db_rows=None, kept=None) -> Dict:
    t0 = time.perf_counter()
    lim = job.limits
    out: Dict[str, Dict] = {}

    # rows persisted for every chunk of every call attempted
    missing = 0
    for nm in attempted:
        p = pool[nm.split("-", 1)[1]]
        want = expected_chunks(p["samples"], p["sample_rate"], pcfg)
        ok = sum(1 for r in rows.get(nm, []) if not r.get("error"))
        missing += abs(want - ok)
    out["rows_missing"] = _entry(missing, lim["rows_missing"])
    if db_rows is not None:
        from . import prod
        out.update(prod.check_db(db_rows, attempted, pool, pcfg, lim))

    # the sampled device batches against the reference
    w = weights.make(weights.w2v_bert_layout(m), w_seed, device)
    sr = int(pcfg.target_sample_rate)
    cache: Dict = {}
    read_pcm = job.generator.read_pcm
    work = []   # (audio row [n], program ids [L'], program mask [L'])
    text_bad = feat_rows = 0
    feats_p, feats_r, feats_c = [], [], []
    for item in sample:
        for j, (fname, cidx, ts, te) in enumerate(item["chunks"]):
            src = _source_rows(pool[fname.split("-", 1)[1]], ts, te, cache,
                               read_pcm, sr)
            a, c = src[0], src[1]
            views = [(a.float() + c.float()) * 0.5, a.float(), c.float()]
            for v, wave in enumerate(views):
                lg = item.get("logits")
                work.append((wave, item["ids"][3 * j + v],
                             item["mask"][3 * j + v],
                             None if lg is None else lg[3 * j + v]))
            file_rows = rows.get(fname, [])
            texts = [ref.ctc_text(item["ids"][3 * j + v][
                item["mask"][3 * j + v].astype(bool)], vocab_list,
                m["pad_token_id"]) for v in range(3)]
            if kept is not None:   # transcripts the benchmark replaced
                texts = [kept["replaced"].get((fname, cidx, f), t)
                         for f, t in zip(TEXT_FIELDS, texts)]
            if cidx >= len(file_rows) or any(
                    file_rows[cidx][f] != t
                    for f, t in zip(TEXT_FIELDS, texts)):
                text_bad += 1
            with ref.no_tf32():
                for s, wave in ((0, a), (1, c)):
                    feats_p.append(item["af"][j, s].astype(np.float64))
                    feats_r.append(ref_ac.features(
                        wave.float().to(device)).numpy())
                    if job.control:
                        feats_c.append(ref_ac.features(
                            wave.float().to(device),
                            dtype=torch.bfloat16).numpy())
                    feat_rows += 1
    out["text_mismatch"] = _entry(text_bad, lim["text_mismatch"])
    if feats_p:
        P, R = np.stack(feats_p), np.stack(feats_r)
        out["feature_err_max"] = _entry(feature_err(P, R),
                                        lim["feature_err_max"])
        if job.control:
            job.readings["feature_err_max.bf16_reference"] = feature_err(
                np.stack(feats_c), R)

    gap, gap_sum, frame_bad, n_frames = 0.0, 0.0, 0, 0
    err_sq = ref_sq = 0.0
    not_argmax = 0
    groups: Dict[int, list] = {}
    for wave, ids, mask, plog in work:
        L = ref.n_frames(wave.shape[0])
        if int(mask.sum()) != L:
            frame_bad += 1
            continue
        keep = mask.astype(bool)
        groups.setdefault(L, []).append(
            (wave, ids[keep], None if plog is None else plog[keep]))
    with torch.inference_mode():
        for L, items in groups.items():
            for i in range(0, len(items), BLOCK_ROWS):
                blk = items[i:i + BLOCK_ROWS]
                feats = torch.stack([ref.fbank(wv.to(device))
                                     for wv, _, _ in blk])
                lg = ref.logits(w, m, feats)
                ids = torch.from_numpy(np.stack([x for _, x, _ in blk])) \
                    .to(device).long()
                if all(p is not None for _, _, p in blk):
                    pl = torch.from_numpy(np.stack([p for _, _, p in blk])) \
                        .to(device).double()
                    not_argmax += int((pl.argmax(-1) != ids).sum())
                    err_sq += float((pl - lg.double()).pow(2).sum())
                    ref_sq += float(lg.double().pow(2).sum())
                served = lg.gather(-1, ids[..., None])[..., 0]
                g = (lg.max(-1).values - served).double()
                gap = max(gap, float(g.max()))
                gap_sum += float(g.sum())
                n_frames += ids.numel()
                del lg, feats
    out["frame_mismatch"] = _entry(frame_bad, lim["frame_mismatch"])
    # nothing compared is no evidence: it fails
    out["logit_rel_mse"] = _entry(err_sq / ref_sq if ref_sq > 0
                                  else math.inf, lim["logit_rel_mse"])
    out["served_not_argmax"] = _entry(not_argmax if n_frames else math.inf,
                                      lim["served_not_argmax"])
    job.readings["logit_gap_mean"] = gap_sum / max(n_frames, 1)
    job.readings["logit_gap_max"] = gap
    if kept is not None:
        from . import prod
        out.update(prod.check_text(job, kept, rows, device, lim))
    del w
    job.say(f"[check] {len(sample)} device batches, {len(work)} rows, "
            f"{n_frames} frames, {feat_rows} feature rows, reference "
            f"{time.perf_counter() - t0:.2f} s")
    for k, v in out.items():
        if not math.isfinite(v["value"]):   # JSON has no infinity
            v["value"] = 1e30
    return out


def feature_err(P: np.ndarray, R: np.ndarray) -> float:
    """max |P - R| over rows and features, each feature's error relative to
    its largest magnitude over the rows of R (a feature that is 0 in every
    row of R counts its absolute error)."""
    scale = np.abs(R).max(axis=0)
    scale = np.where(scale > 0, scale, 1.0)
    err = np.abs(P - R) / scale
    err = np.where(np.isnan(err), np.inf, err)
    return float(err.max()) if err.size else 0.0
