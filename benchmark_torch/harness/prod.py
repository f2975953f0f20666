"""The production stack of a batch cell: client and agent text classifiers,
the acoustic heads, late fusion and a SQLite database, set up by the
benchmark from the seed, and their part of the comparison.

The card has no joblib, sklearn or transformers, so nothing is loaded
from files: the classifiers' weights are drawn on the device
(``weights.bert_layout``) and put into the port's
``BertForSequenceClassification``; the tokenizer is the port's WordPiece
over a vocabulary the benchmark builds; the heads are the converted dicts
``AcousticSentimentAnalyzer._load_one`` would build, drawn from the seed
(:func:`heads`). The random ASR weights give transcripts whose length,
and so the classifiers' work, changes with the seed; every agent and client
transcript is therefore replaced before analysis by ``transcript_words``
words cycled from the configuration's phrases (a speaker's share of a 25 s
chunk of conversation), so each seed gives the classifiers the same work.
The phrases' words are whole tokens of the benchmark's vocabulary, as a
real WordPiece vocabulary holds common words.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List

import numpy as np
import torch

from . import weights
from .check import expected_chunks

K_BATCHES = 1    # sampled analysis batches (every chunk of each)


def bert_vocab(size: int, ctc_vocab: List[str],
               words: List[str]) -> Dict[str, int]:
    """A BERT-style vocabulary of ``size`` entries: [PAD], [unused*],
    [UNK], [CLS], [SEP], [MASK] at BERT-base's ids, the transcripts'
    characters whole and as ``##`` pieces, punctuation, ``words`` whole,
    then fillers."""
    chars = [t for t in ctc_vocab if len(t) == 1 and t != "|"]
    toks = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars
            + ["##" + c for c in chars] + list(".,!?،؟"))
    toks += [w for w in dict.fromkeys(words) if w not in toks]
    toks += [f"[unused{i}]" for i in range(99, 99 + size - len(toks))]
    return {t: i for i, t in enumerate(toks)}


def heads(seed: int, spec: Dict, classes: List[str]) -> tuple:
    """(scaler, svc, forest) as the port's ``sklearn_infer.convert_*``
    give them: a scaler over the features, a k-class RBF SVC with
    ``n_sv`` support vectors, duals in [-1, 1] and Platt coefficients,
    and a forest of ``n_trees`` trees grown breadth first (a node splits
    with probability 0.8, up to ``max_depth`` levels and ``max_nodes``
    nodes) with a class distribution at every node."""
    rng = np.random.default_rng(seed)
    d, k = spec["n_features"], len(classes)
    n_sv, n_trees = spec["n_sv"], spec["n_trees"]
    scaler = {"mean": rng.normal(0, 3, d).astype(np.float32),
              "scale": rng.uniform(0.5, 4, d).astype(np.float32)}
    n_support = np.full(k, n_sv // k, np.int32)
    n_support[:n_sv - int(n_support.sum())] += 1
    pairs = k * (k - 1) // 2
    cls = np.array(classes)
    svc = {"support_vectors": rng.standard_normal((n_sv, d)).astype(
               np.float32),
           "dual_coef": rng.uniform(-1, 1, (k - 1, n_sv)).astype(np.float32),
           "intercept": rng.normal(0, 0.3, pairs).astype(np.float32),
           "n_support": n_support,
           "prob_a": rng.uniform(-4, -1, pairs).astype(np.float32),
           "prob_b": rng.normal(0, 0.2, pairs).astype(np.float32),
           "gamma": np.float32(1.0 / d), "kernel": "rbf",
           "coef0": np.float32(0.0), "degree": 3, "classes": cls}
    trees = []
    for _ in range(n_trees):
        left, right, feat, thr, depth = [-1], [-1], [0], [0.0], [0]
        frontier = [0]
        while frontier:
            grown = []
            for n in frontier:
                if depth[n] < spec["max_depth"] \
                        and len(left) + 2 <= spec["max_nodes"] \
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
              "max_depth": max(t[4] for t in trees), "classes": cls}
    for i, (lft, rgt, feat, thr, _) in enumerate(trees):
        n = len(lft)
        forest["left"][i, :n], forest["right"][i, :n] = lft, rgt
        forest["feature"][i, :n], forest["threshold"][i, :n] = feat, thr
        forest["value"][i, :n] = rng.dirichlet(np.ones(k), n)
    return scaler, svc, forest


def _words(job) -> List[str]:
    return " ".join(job.config["analyzers"]["phrases"]).split()


def _text_weights(job, speaker: str, device):
    tm = job.config["text_model"]
    return weights.make(weights.bert_layout(tm),
                        weights.sub_seed(job.seed, f"{speaker}-text"),
                        device, scale={"classifier.weight": 50.0})


def setup(job, pcfg, dev, root, database: bool = True) -> Dict:
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.host.db import DatabaseManager
    from audio_processor_tpu_torch.models import bert as bert_mod
    from audio_processor_tpu_torch.models.bert_tokenizer import BertTokenizer
    from audio_processor_tpu_torch.pipeline.sentiment import (
        SentimentAnalyzer,
    )

    an = job.config["analyzers"]
    tm = job.config["text_model"]
    job.mark("text import")
    db = DatabaseManager(PipelineConfig.from_dict(dict(
        job.config["pipeline"], output_folder=str(root / "out"),
        db_path=str(root / "out" / "calls.db")))) if database else None
    sa = SentimentAnalyzer(pcfg, db_manager=db, device=dev)
    job.mark("database")
    tok = BertTokenizer(bert_vocab(tm["vocab_size"], job.config["vocab"],
                                   _words(job)))
    cfg = bert_mod.BertConfig(**{k: tm[k] for k in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "type_vocab_size", "num_labels",
        "layer_norm_eps")})
    labels = {"client": an["client_labels"], "agent": an["agent_labels"]}
    for speaker in ("client", "agent"):
        sd = {"bert." + k if not k.startswith("classifier") else k: v
              for k, v in _text_weights(job, speaker, dev).items()}
        with torch.device("meta"):
            model = bert_mod.BertForSequenceClassification(cfg)
        model.load_state_dict(sd, assign=True, strict=True)
        if str(pcfg.get("quantization", "none")) == "int8":
            model = bert_mod.quantize_model(model)
        sa.text_analyzer.models[speaker] = {
            "model": model.eval(), "cfg": cfg, "tokenizer": tok,
            "id2label": dict(enumerate(labels[speaker]))}
    sa.text_analyzer.models_available = True
    job.mark("text models")
    hs = {}
    for speaker, kind in (("client", "svc"), ("agent", "forest")):
        scaler, svc, forest = heads(
            weights.sub_seed(job.seed, f"{speaker}-heads"), an["heads"],
            labels[speaker])
        hs[speaker] = {"scaler": scaler, "kind": kind,
                       "model": svc if kind == "svc" else forest,
                       "classes": np.asarray(labels[speaker])}
        sa.acoustic_analyzer.models[speaker] = {
            "scaler": scaler, "n_features": an["heads"]["n_features"],
            "classes": np.asarray(labels[speaker]), "kind": kind,
            "model": hs[speaker]["model"]}
    ac = sa.acoustic_analyzer
    ac.models_available = True
    ac.client_acoustic_id2label = ac._id2label("client")
    ac.agent_acoustic_id2label = ac._id2label("agent")
    sa.late_fusion_analyzer.client_id2label = ac.client_acoustic_id2label
    sa.late_fusion_analyzer.agent_id2label = ac.agent_acoustic_id2label
    return {"sentiment": sa, "db": db, "heads": hs, "labels": labels,
            "sample": [], "replaced": {}}


def warm(job, an, chunk_counts) -> None:
    """The classifiers at the token bucket of a replaced transcript and at
    each batch the mix's analysis batches give (their chunk counts, padded
    to a multiple of 16 as the analyzer pads)."""
    ta = an["sentiment"].text_analyzer
    words = _words(job)
    text = " ".join(words[i % len(words)] for i in range(
        int(job.config["analyzers"]["transcript_words"])))
    tok = ta.models["client"]["tokenizer"]
    L = ta._bucket_len(tok([text], max_length=512)["input_ids"].shape[1])
    sizes = sorted({16 * max(1, -(-n // 16)) for n in chunk_counts})
    with torch.inference_mode():
        for speaker in ("client", "agent"):
            model = ta.models[speaker]["model"]
            dev = next(model.parameters()).device
            for rows in sizes:
                ids = torch.zeros((rows, L), dtype=torch.int32, device=dev)
                model(ids, torch.ones((rows, L), device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()


def wrap(job, rec, runrec, an, tracing_window, name_of=None) -> None:
    """Replace short transcripts, span the analysis and the classifiers,
    and keep a seeded sample of analysis batches with the token ids and
    logits the classifiers were given and gave. ``name_of(chunk)`` names
    a chunk's call (its file name by default)."""
    from audio_processor_tpu_torch.models import bert as bert_mod
    from audio_processor_tpu_torch.pipeline import sentiment as sent_mod

    name = name_of or (lambda c: c["file_name"])
    rng = random.Random(weights.sub_seed(job.seed, "text-sample"))
    state = {"seen": 0, "turn": 0}
    lock = threading.Lock()
    local = threading.local()     # the analysis of one thread at a time

    words = _words(job)
    per = int(job.config["analyzers"]["transcript_words"])

    def substitute(args, kwargs):
        with lock:
            for c in args[1]:
                for key in ("agent_transcription", "client_transcription"):
                    start = (state["turn"] * 7) % len(words)
                    state["turn"] += 1
                    text = " ".join(words[(start + i) % len(words)]
                                    for i in range(per))
                    an["replaced"][(name(c), c["chunk_idx"], key)] = text
                    c[key] = text

    def analyze_before(args, kwargs):
        with lock:
            state["seen"] += 1
            n = len(an["sample"])
            slot = n if n < K_BATCHES else rng.randrange(state["seen"])
        local.slot = slot if slot < K_BATCHES else None
        local.fwd = []

    def analyze_after(out, args, kwargs, t0, t1):
        slot = getattr(local, "slot", None)
        local.slot = None
        if slot is None:
            return
        chunks = [{"file_name": name(c), "chunk_idx": c["chunk_idx"],
                   "agent_transcription": c.get("agent_transcription", ""),
                   "client_transcription": c.get("client_transcription", ""),
                   "agent_features": np.asarray(c["agent_acoustic_features"]),
                   "client_features":
                       np.asarray(c["client_acoustic_features"])}
                  for c in args[1]]
        item = {"chunks": chunks, "results": out, "forward": local.fwd}
        with lock:
            if slot < len(an["sample"]):
                an["sample"][slot] = item
            else:
                an["sample"].append(item)

    def forward_after(out, args, kwargs, t0, t1):
        if getattr(local, "slot", None) is not None:
            local.fwd.append((args[1].cpu().numpy(), args[2].cpu().numpy(),
                              out.detach().cpu().numpy()))

    S, T = sent_mod.SentimentAnalyzer, sent_mod.TextSentimentAnalyzer
    rec.wrap(S, "analyze_batch_sentiment", "sentiment", before=substitute)
    rec.wrap(S, "_analyze_batch", "sentiment.batch", analyze_before,
             analyze_after)
    rec.wrap(T, "dispatch_batch", "text.dispatch")
    rec.wrap(bert_mod.BertForSequenceClassification, "forward",
             "text.forward", after=forward_after)


def read_db(an) -> Dict[str, List]:
    rows = an["db"]._execute(
        "SELECT id_enregistrement, id_chunk, emotion_client, ton_agent "
        "FROM chunk", (), fetch="all") or []
    out: Dict[str, List] = {}
    for r in rows:
        out.setdefault(r["id_enregistrement"], []).append(
            (int(r["id_chunk"]), r["emotion_client"], r["ton_agent"]))
    return out


def close(job, an) -> Dict:
    """Close the database; returns what the comparison needs (no device
    memory)."""
    job.say(f"[text] agent and client transcripts replaced before "
            f"analysis: {len(an['replaced'])}")
    if an["db"] is not None:
        an["db"].close()
    return {k: an[k] for k in ("sample", "labels", "heads", "replaced")}


def check_db(db_rows, attempted, pool, pcfg, lim) -> Dict:
    missing = 0
    for nm in attempted:
        p = pool[nm.split("-", 1)[1]]
        want = expected_chunks(p["samples"], p["sample_rate"], pcfg)
        have = len({c for c, _, _ in db_rows.get(nm.rsplit(".", 1)[0], [])})
        missing += abs(want - have)
    return {"db_rows_missing": {"value": float(missing),
                                "limit": float(lim["db_rows_missing"])}}


def check_text(job, kept, rows, device, lim) -> Dict:
    """Text classifiers' logits, the heads' probabilities and the fusion
    labels of the sampled analysis batches against the reference."""
    from ..reference import bert as ref_bert
    from ..reference import heads as ref_heads

    sample, an_labels, an_heads = kept["sample"], kept["labels"], kept["heads"]
    tm = job.config["text_model"]
    text_err = head_err = 0.0
    ctrl_text = ctrl_head = 0.0
    fusion_bad = fusion_n = 0
    for item in sample:
        chunks, results = item["chunks"], item["results"]
        ref_text = {}
        for (ids, mask, prog), speaker in zip(item["forward"],
                                              ("agent", "client")):
            w = _text_weights(job, speaker, device)
            valid = mask.sum(-1) > 0
            with torch.inference_mode():
                ref = ref_bert.logits(
                    w, tm, torch.from_numpy(ids).to(device),
                    torch.from_numpy(mask).to(device)).double().cpu().numpy()
                if job.control:
                    tf = ref_bert.logits(
                        w, tm, torch.from_numpy(ids).to(device),
                        torch.from_numpy(mask).to(device),
                        tf32=True).double().cpu().numpy()
                    ctrl_text = max(ctrl_text, _rel(tf[valid], ref[valid]))
            del w
            text_err = max(text_err, _rel(prog[valid].astype(np.float64),
                                          ref[valid]))
            ref_text[speaker] = ref[valid]
        for speaker in ("agent", "client"):
            h = an_heads[speaker]
            feats = np.stack([c[f"{speaker}_features"] for c in chunks])
            x = ref_heads.scale(h["scaler"], feats)
            if h["kind"] == "svc":
                lab, probs = ref_heads.svc(h["model"], x)
            else:
                probs = ref_heads.forest(h["model"], x)
                lab = probs.argmax(-1)
            probs = probs.numpy()
            if job.control:
                xc = ref_heads.scale(h["scaler"], feats, torch.bfloat16)
                pc = (ref_heads.svc(h["model"], xc, torch.bfloat16)[1]
                      if h["kind"] == "svc" else
                      ref_heads.forest(h["model"], xc, torch.bfloat16))
                ctrl_head = max(ctrl_head, float(np.abs(
                    pc.numpy() - probs).max()))
            classes = an_labels[speaker]
            t_probs = _softmax(ref_text.get(speaker, np.zeros((0, 4))))
            row = 0
            for j, c in enumerate(chunks):
                r = results[j]
                pa = r.get(f"{speaker}_acoustic_probabilities") or []
                if len(pa):
                    head_err = max(head_err, float(np.abs(
                        np.asarray(pa) - probs[j]).max()))
                text = c[f"{speaker}_transcription"]
                if not (text and len(text.strip()) >= 5):
                    continue
                tp = t_probs[row]
                row += 1
                t_label = classes[int(np.argmax(tp))]
                label, margin = ref_heads.fuse(
                    speaker, t_label, float(tp.max()), tp,
                    classes[int(lab[j])], probs[j], classes)
                if margin is not None and margin < 1e-4:
                    continue            # a near tie decides nothing
                file_rows = rows.get(c["file_name"], [])
                got = (file_rows[c["chunk_idx"]][f"{speaker}_fusion_sentiment"]
                       if c["chunk_idx"] < len(file_rows) else None)
                fusion_n += 1
                fusion_bad += int(got != label)
    if job.control:
        job.readings["text_logit_err_max.tf32_reference"] = ctrl_text
        job.readings["head_prob_err_max.bf16_reference"] = ctrl_head
    job.readings["fusion_compared"] = fusion_n
    return {
        "text_logit_err_max": {"value": text_err if sample else 1e30,
                               "limit": float(lim["text_logit_err_max"])},
        "head_prob_err_max": {"value": head_err,
                              "limit": float(lim["head_prob_err_max"])},
        "fusion_mismatch": {"value": float(fusion_bad),
                            "limit": float(lim["fusion_mismatch"])},
    }


def _rel(p: np.ndarray, r: np.ndarray) -> float:
    """max |p - r| over the largest |r|."""
    if r.size == 0:
        return 0.0
    return float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-30))


def _softmax(x: np.ndarray) -> np.ndarray:
    if x.size == 0:
        return x
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)

