"""Driver of the topics cell: the production stack of :mod:`.batch` and
:mod:`.prod` (w2v-bert-2.0 ASR, both DarijaBERT classifiers, the heads,
fusion, SQLite, CSV) with ``topic_backend: local``, so that every analysis
batch's calls are summarised and classified on the card by the topic LM
(``models/moe_lm.py``, Moonlight-16B-A3B at its published widths) through
``SentimentAnalyzer`` → ``TopicClassifier.infer_batch``. Window, sweeps,
set-up and end-to-end metrics are :mod:`.batch`'s.

The topic LM is imported first: a program without it fails here, at once.

Set-up adds to :mod:`.batch`'s: the LM's weights drawn on the device from
the seed in bf16, each tensor from a generator of its own
(:func:`lm_layout`, :func:`draw`; the reference draws them again one layer
at a time), the glossary written as an xlsx sheet ``explication`` from the
configuration's seed (:func:`glossary_rows`), and the whole pool swept
once through the whole pipeline, which captures the decode step graph of
every (rows, cache capacity) key the window uses (the prompts are the same
in every sweep) and gives the prefill each file batch's token counts: the
first sweep over them ran 0.5-0.8 s slower per file batch than later ones
when only one file batch was warmed (PERF.md). Every chunk's mixed-channel
``transcription_chunk`` is replaced before analysis by words cycled from
the configuration's phrases, as many as the configuration's seed drew for
that call and chunk (30-90 per 25 s chunk, a tail its share), so the
prompts are the same in every run.

The comparison adds to :mod:`.check`'s (with :mod:`.prod`'s) the topic
LM's, on one seeded analysis batch of the window (all its calls): the
program keeps, for both prompts of every row, the prompt ids, the logits
of its first token and of ``STEPS`` seeded decode steps (the class prompt
has two), the tokens it emitted and every expert it chose. With the
program freed, the plain reference (``reference/moonlight.py``, fp32, TF32
off, each sequence alone) recomputes the logits at each prompt's last
position and at those steps, teacher forced on the emitted tokens:

- ``topic_logit_rel_mse``: the sum of squared differences over the sum of
  squared reference logits;
- ``topic_step_rel_mse_max``: the largest such ratio of one row's logits
  at one tapped decode step, where the program reads its latent cache
  (the first tokens of the pooled number come from the prefill alone);
- ``topic_not_argmax``: compared tokens that are not the argmax of the
  program's own logits (exact);
- ``route_mismatch``: token positions and layers whose expert set the
  reference chooses otherwise, beyond a tie (exact); where the
  reference's k-th biased score exceeds the program's lowest chosen one by
  at most :data:`ROUTE_TIE_TOL`, the reference takes the program's choice
  and counts a ``route_ties`` (a reading);
- ``topics_missing``: calls completed in the window whose SQLite
  ``topics`` holds no answer: empty, or one of the stand-ins the program
  writes where it computed none (:data:`NO_ANSWER`) (exact).

A sample without the taps of both prompts fails every topic LM check.

The control (``job.control``) rounds every latent the program caches to
fp8 e4m3 (a scale per token and layer), the precision below the
configured bf16, for the whole run.
"""

from audio_processor_tpu_torch.models import moe_lm   # noqa: I001 first

import collections
import gc
import math
import random
import statistics
import threading
import time
import zipfile
from pathlib import Path
from typing import Dict, List
from xml.sax.saxutils import escape

import numpy as np
import torch

from . import check, prod, weights
from .batch import (
    Run, _chunk_counts, _end_to_end, _link_sweep, _pool_name,
    _profile_sweep, _read_csv, _shapes, build_engine, capture_sample,
)
from .job import Job
from .spans import Recorder
from ..reference import moonlight as ref_lm

STEPS = 4            # sampled decode steps per row and prompt
# The stand-in weights' stds: the attention's q, W_kvb and W_o twice the
# others (models/moe_lm.py's ATTENTION_SCALE and why), the correction bias.
STD, WIDE_STD, BIAS_STD = 0.02, 0.04, 0.05
# The reference's k-th biased score may exceed the program's lowest chosen
# expert's by this much and still count as a tie: the bf16 program's
# hidden states, 27 layers deep, differ from the fp32 reference's enough
# to move a sigmoid score by up to 0.019 (the largest margin of a
# disagreement over 6 seeds of ≈ 1.1 M choices each, PERF.md); the fp8
# control's reach 0.13-0.16.
ROUTE_TIE_TOL = 5e-2
KINDS = ("summary", "class")
# ``topics`` of a call the program gave no answer: empty, or the
# (category - type) of ``host/topics.py``'s stand-ins for an unavailable
# service, a missing glossary and a failed or refused inference.
NO_ANSWER = {"", "Appel blanc - Non classifié", "Appel blanc - Erreur"}


def lm_config(config: Dict) -> moe_lm.MoELMConfig:
    """The LM's widths: the configuration's top-level (published) keys."""
    return moe_lm.MoELMConfig.from_dict(config)


def lm_layout(m: moe_lm.MoELMConfig) -> weights.Layout:
    """Parameter names, shapes and kinds ("normal", "wide", "ones", "bias")
    of the program's ``MoELM``."""
    h, nh, f = m.hidden_size, m.num_attention_heads, m.moe_intermediate_size
    E = m.n_routed_experts
    out = [("embed_tokens.weight", (m.vocab_size, h), "normal")]
    for i in range(m.num_hidden_layers):
        p = f"layers.{i}"
        a = f"{p}.self_attn"
        out += [(f"{p}.input_layernorm.weight", (h,), "ones"),
                (f"{p}.post_attention_layernorm.weight", (h,), "ones"),
                (f"{a}.q_proj.weight", (nh * m.qk_head_dim, h), "wide"),
                (f"{a}.kv_a_proj_with_mqa.weight", (m.latent_dim, h),
                 "normal"),
                (f"{a}.kv_a_layernorm.weight", (m.kv_lora_rank,), "ones"),
                (f"{a}.kv_b_proj.weight",
                 (nh * (m.qk_nope_head_dim + m.v_head_dim), m.kv_lora_rank),
                 "wide"),
                (f"{a}.o_proj.weight", (h, nh * m.v_head_dim), "wide")]
        if not m.is_moe(i):
            w = m.intermediate_size
            out += [(f"{p}.mlp.gate_up_proj.weight", (2 * w, h), "normal"),
                    (f"{p}.mlp.down_proj.weight", (h, w), "normal")]
            continue
        s = f * m.n_shared_experts
        out += [(f"{p}.mlp.gate.weight", (E, h), "normal"),
                (f"{p}.mlp.gate.e_score_correction_bias", (E,), "bias"),
                (f"{p}.mlp.experts.gate_up_proj", (E, 2 * f, h), "normal"),
                (f"{p}.mlp.experts.down_proj", (E, h, f), "normal"),
                (f"{p}.mlp.shared_experts.gate_up_proj.weight", (2 * s, h),
                 "normal"),
                (f"{p}.mlp.shared_experts.down_proj.weight", (h, s),
                 "normal")]
    out += [("norm.weight", (h,), "ones"),
            ("lm_head.weight", (m.vocab_size, h), "normal")]
    return out


def draw(name: str, shape, kind: str, seed: int, device) -> torch.Tensor:
    """One parameter, from a generator of its own seeded by (seed, name):
    bf16, the correction bias fp32."""
    if kind == "ones":
        return torch.ones(shape, dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(
        weights.sub_seed(seed, name))
    t = torch.empty(shape, device=device, dtype=torch.float32
                    if kind == "bias" else torch.bfloat16)
    std = {"normal": STD, "wide": WIDE_STD, "bias": BIAS_STD}[kind]
    return t.normal_(0.0, std, generator=gen)


def build_lm(m: moe_lm.MoELMConfig, seed: int, device) -> moe_lm.MoELM:
    """The program's model over the drawn weights."""
    sd = {n: draw(n, s, k, seed, device) for n, s, k in lm_layout(m)}
    with torch.device("meta"):
        model = moe_lm.MoELM(m)
    model.cast(torch.bfloat16)
    model.load_state_dict(sd, assign=True, strict=True)
    del sd
    return model.eval()


def fp8_latents(project):
    """``LatentAttention.project`` whose latents come back rounded to fp8
    e4m3 with a scale per row (the control)."""
    def rounded(self, x, cos, sin):
        q_nope, q_pe, latent = project(self, x, cos, sin)
        w = latent.float()
        scale = 448.0 / w.abs().amax(-1, keepdim=True).clamp(min=1e-12)
        return q_nope, q_pe, ((w * scale).to(torch.float8_e4m3fn).float()
                              / scale).to(latent.dtype)
    return rounded


def lm_getter(m: moe_lm.MoELMConfig, seed: int, device):
    """``get(name)`` for the reference: each parameter drawn again from the
    seed and upcast to fp32, the last layer read kept."""
    kinds = {n: (s, k) for n, s, k in lm_layout(m)}
    state = _Lazy(kinds, seed, device)
    return ref_lm.layer_params(state, device)


class _Lazy(dict):
    def __init__(self, kinds, seed, device):
        super().__init__()
        self.kinds, self.seed, self.device = kinds, seed, device

    def __missing__(self, name):
        shape, kind = self.kinds[name]
        return draw(name, shape, kind, self.seed, self.device)


def glossary_rows(an: Dict) -> List[List[str]]:
    """The seeded B2C glossary: a header, then one row per (category,
    type) with ``explanation_words`` words of ``glossary_words``."""
    t = an["topics"]
    rng = random.Random(int(t["seed"]))
    words = t["glossary_words"]
    rows = [["Catégorie", "Type de spécialité", "Explication"]]
    for cat in t["categories"]:
        for typ in t["types"]:
            rows.append([cat, typ, " ".join(
                rng.choice(words) for _ in range(int(t["explanation_words"])))
                .capitalize() + "."])
    return rows


def write_xlsx(path: Path, sheet: str, rows: List[List[str]]) -> None:
    """A one-sheet workbook of inline strings, as the port's reader
    (``host/xlsx.py``) reads it."""
    ns = "http://schemas.openxmlformats.org"
    cells = "".join(
        f'<row r="{i + 1}">' + "".join(
            f'<c r="{chr(65 + j)}{i + 1}" t="inlineStr"><is><t>'
            f'{escape(str(v))}</t></is></c>' for j, v in enumerate(r))
        + "</row>" for i, r in enumerate(rows))
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("[Content_Types].xml", (
            f'<?xml version="1.0"?><Types xmlns="{ns}/package/2006/'
            'content-types"><Default Extension="xml" ContentType='
            '"application/xml"/></Types>'))
        z.writestr("xl/workbook.xml", (
            f'<?xml version="1.0"?><workbook xmlns="{ns}/spreadsheetml/'
            f'2006/main" xmlns:r="{ns}/officeDocument/2006/relationships">'
            f'<sheets><sheet name="{escape(sheet)}" sheetId="1" '
            'r:id="rId1"/></sheets></workbook>'))
        z.writestr("xl/_rels/workbook.xml.rels", (
            f'<?xml version="1.0"?><Relationships xmlns="{ns}/package/2006/'
            'relationships"><Relationship Id="rId1" Type="'
            f'{ns}/officeDocument/2006/relationships/worksheet" '
            'Target="worksheets/sheet1.xml"/></Relationships>'))
        z.writestr("xl/worksheets/sheet1.xml", (
            f'<?xml version="1.0"?><worksheet xmlns="{ns}/spreadsheetml/'
            f'2006/main"><sheetData>{cells}</sheetData></worksheet>'))


def chunk_words(job: Job, pool_calls: int) -> np.ndarray:
    """[call, chunk] words of a full 25 s chunk, drawn once from the
    configuration's seed."""
    t = job.config["analyzers"]["topics"]
    lo, hi = t["words_per_chunk"]
    return np.random.default_rng(int(t["seed"])).integers(
        lo, hi + 1, size=(pool_calls, 64))


def _setup_topics(job: Job, pcfg, dev, root: Path, sa):
    """The glossary, the local ``TopicClassifier`` over the drawn LM, put
    into the analyzers -> (classifier, LM config, weight seed)."""
    from audio_processor_tpu_torch.host.topics import LocalLM, TopicClassifier

    gloss = root / "glossaire_b2c.xlsx"
    write_xlsx(gloss, "explication", glossary_rows(job.config["analyzers"]))
    m = lm_config(job.config)
    lm_seed = weights.sub_seed(job.seed, "lm-weights")
    spec = dict(vars(m), **{k: job.config[k] for k in (
        "user_token_id", "assistant_token_id") if k in job.config})
    cfg = pcfg.replace(topics_glossary_b2c=str(gloss), extras=dict(
        pcfg.extras, topic_model=spec))
    local = LocalLM(cfg, dev, model=build_lm(m, lm_seed, dev))
    tc = TopicClassifier(cfg, device=dev, local=local)
    if not tc.enabled:
        raise RuntimeError("the local topic classifier did not load its "
                           "glossary")
    sa.topic_classifier = tc
    return tc, m, lm_seed


def _wrap_topics(job: Job, rec: Recorder, an: Dict, tc, words_of,
                 sample: Dict) -> None:
    """Replace each chunk's mixed-channel transcript before analysis, and
    keep one seeded analysis batch's taps (reservoir of one)."""
    from audio_processor_tpu_torch.host.topics import TopicClassifier
    from audio_processor_tpu_torch.pipeline import sentiment as sent_mod

    words = prod._words(job)
    chunk_s = float(job.config["pipeline"]["chunk_duration_sec"])
    rng = random.Random(weights.sub_seed(job.seed, "topic-sample"))
    tap_rng = random.Random(weights.sub_seed(job.seed, "topic-taps"))
    lm = tc.local.model
    state = {"seen": 0}
    local = threading.local()

    def substitute(args, kwargs):
        for c in args[1]:
            name = c["file_name"]
            call = int(_pool_name(name).split("-")[1].split(".")[0])
            k = int(c["chunk_idx"])
            share = (float(c["end_time"]) - float(c["start_time"])) / chunk_s
            n = int(round(words_of[call, k] * min(1.0, share)))
            start = (call * 13 + k * 5) % len(words)
            text = " ".join(words[(start + i) % len(words)]
                            for i in range(n))
            an["replaced"][(name, c["chunk_idx"], "transcription_chunk")] = \
                text
            c["transcription_chunk"] = text

    def tap(kind, rows, steps):
        return tap_rng.sample(range(1, steps + 1), min(STEPS, steps))

    def before(args, kwargs):
        state["seen"] += 1
        armed = not sample or rng.randrange(state["seen"]) == 0
        local.armed = armed
        if armed:
            lm.tap, lm.tapped = tap, {}

    def after(out, args, kwargs, t0, t1):
        if getattr(local, "armed", False):
            sample.clear()
            sample.update(lm.tapped)
            lm.tap, lm.tapped = None, {}
        local.armed = False

    rec.wrap(sent_mod.SentimentAnalyzer, "analyze_batch_sentiment",
             "sentiment.topics_text", before=substitute)
    rec.wrap(TopicClassifier, "infer_batch", "topics.batch", before, after)


def run(job: Job) -> Dict:
    """One run of the topics cell; returns the result object."""
    dev = torch.device(job.device)
    cuda = dev.type == "cuda"
    m_asr = dict(job.config["model"])
    root = job.tmp
    rec = Recorder()
    runrec = Run(job, rec, m_asr)
    project = moe_lm.LatentAttention.project
    if job.control:
        moe_lm.LatentAttention.project = fp8_latents(project)
    try:
        return _run(job, dev, cuda, m_asr, root, rec, runrec)
    finally:
        moe_lm.LatentAttention.project = project


def _run(job, dev, cuda, m_asr, root, rec, runrec) -> Dict:
    from audio_processor_tpu_torch.pipeline import engine as engine_mod
    from audio_processor_tpu_torch.pipeline.batching import (
        create_file_batches,
    )
    from audio_processor_tpu_torch.pipeline.chunker import Chunk

    # ---- set-up ------------------------------------------------------
    engine, pcfg, w_seed = build_engine(job, dev, root)
    analyzers = prod.setup(job, pcfg, dev, root, database=True)
    job.mark("text+heads")
    tc, m_lm, lm_seed = _setup_topics(job, pcfg, dev, root,
                                      analyzers["sentiment"])
    job.mark("topic LM")
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
    proc = engine_mod.DataProcessor(
        pcfg, device=dev, asr_engine=engine,
        sentiment_analyzer=analyzers["sentiment"], db_manager=analyzers["db"])
    proc.setup_models()
    prod.warm(job, analyzers, _chunk_counts(pool, names_per_batch, pcfg))
    words_of = chunk_words(job, len(pool))
    lm_sample: Dict = {}
    warm_rec = Recorder()      # the warm sweep's transcripts replaced too
    warm_rec.on = True
    _wrap_topics(job, warm_rec, analyzers, tc, words_of, {})
    try:
        proc.process_files_parallel(
            _link_sweep(pool, root / "in" / "warm", "warm"))
    finally:
        warm_rec.restore()
    if cuda:
        torch.cuda.synchronize()

    # ---- spans, counters and the samples for the comparison ----------
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
    prod.wrap(job, rec, runrec, analyzers, runrec.tracing_window)
    _wrap_topics(job, rec, analyzers, tc, words_of, lm_sample)

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
    for layer in ("engine.analysis", "topics.batch"):
        job.say(f"[stages] {layer} s: " + " ".join(
            f"{t1 - t0:.3f}" for name, t0, t1, _ in rec.spans
            if name == layer))
    if job.trace:
        from audio_processor_tpu_torch.obs import profiler

        lo, hi = runrec.tracing_window
        modes = collections.Counter(
            s.attrs.get("mode") for s in profiler.spans()
            if s.name == "topics.graph" and lo is not None
            and hi is not None and lo * 1e9 <= s.t0 <= hi * 1e9)
        job.say(f"[window] traced sweep's topic step graphs by mode: "
                f"{dict(modes)}")

    # ---- the program's outputs, then its state freed ------------------
    proc.close()
    rows = _read_csv(root / "out")
    db_rows = prod.read_db(analyzers)
    topics = {r["id_enregistrement"]: r["topics"] for r in
              analyzers["db"]._execute(
                  "SELECT id_enregistrement, topics FROM call", (),
                  fetch="all") or []}
    kept = prod.close(job, analyzers)
    del proc, engine, analyzers, tc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- comparison with the reference -------------------------------
    checks = check.batch(
        job, m_asr, vocab_list=job.config["vocab"],
        sample=sample["top"] + sample["other"], pool=by_name,
        attempted=attempted, rows=rows, pcfg=pcfg, device=dev,
        w_seed=w_seed, db_rows=db_rows, kept=kept)
    missing = sum(1 for nm in completed
                  if (topics.get(Path(nm).stem) or "") in NO_ANSWER)
    checks["topics_missing"] = check._entry(
        missing if completed else math.inf, job.limits["topics_missing"])
    checks.update(check_topics(job, m_lm, lm_sample, lm_seed, dev))
    for v in checks.values():
        if not math.isfinite(v["value"]):   # JSON has no infinity
            v["value"] = 1e30
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


def check_topics(job: Job, m: moe_lm.MoELMConfig, tapped: Dict,
                 seed: int, device) -> Dict[str, Dict]:
    """The sampled analysis batch's topic LM logits and expert choices
    against the reference (see the module's notes)."""
    t0 = time.perf_counter()
    lim = job.limits
    names = ("topic_logit_rel_mse", "topic_step_rel_mse_max",
             "topic_not_argmax", "route_mismatch")
    if any(tapped.get(kind) is None for kind in KINDS):
        job.say(f"[check] topic LM: taps of {sorted(tapped)}, not of both "
                f"{KINDS}")
        return {k: check._entry(math.inf, lim[k]) for k in names}
    seqs, at, hints, prog, served = [], [], [], [], []
    moe_layers = m.moe_layers
    for kind in KINDS:
        t = tapped[kind]
        ids = t["ids"]
        steps = sorted(t["steps"])
        last = max(steps, default=0)
        start = 0
        for r, p in enumerate(t["prompts"]):
            L = len(p)
            seqs.append(list(p) + ids[r, :last].tolist())
            at.append([L - 1] + [L - 1 + s for s in steps])
            pre = t["prefill_routes"][:, start:start + L]      # [moe, L, k]
            dec = t["decode_routes"][:last, :, r].transpose(0, 1)
            hints.append({layer: torch.cat([pre[j], dec[j]]).long()
                          for j, layer in enumerate(moe_layers)})
            prog.append(torch.stack([t["first_logits"][r]]
                                    + [t["steps"][s][r] for s in steps]))
            served.append([int(ids[r, 0])] + [int(ids[r, s]) for s in steps])
            start += L
    with torch.inference_mode():
        r = ref_lm.forward(lm_getter(m, seed, device), vars(m), seqs, at,
                           hints, ROUTE_TIE_TOL, device=device)
    err = ref_sq = step_err = step_sq = 0.0
    step_max = -math.inf
    not_argmax = 0
    for p, lg, sv in zip(prog, r["logits"], served):
        lg = lg.double().cpu()
        d = (p.double() - lg).pow(2).sum(-1)           # per position
        q = lg.pow(2).sum(-1)
        err += float(d.sum())
        ref_sq += float(q.sum())
        if len(d) > 1:                                  # the decode steps
            step_err += float(d[1:].sum())
            step_sq += float(q[1:].sum())
            step_max = max(step_max, float((d[1:] / q[1:]).max()))
        not_argmax += sum(int(a) != b for a, b in
                          zip(p.argmax(-1).tolist(), sv))
    out = {
        "topic_logit_rel_mse": check._entry(
            err / ref_sq if ref_sq > 0 else math.inf,
            lim["topic_logit_rel_mse"]),
        "topic_step_rel_mse_max": check._entry(
            step_max if step_sq > 0 else math.inf,
            lim["topic_step_rel_mse_max"]),
        "topic_not_argmax": check._entry(not_argmax,
                                         lim["topic_not_argmax"]),
        "route_mismatch": check._entry(r["route_mismatch"],
                                       lim["route_mismatch"])}
    job.readings["topic_step_rel_mse"] = step_err / step_sq \
        if step_sq > 0 else None
    job.readings["route_ties"] = r["route_ties"]
    gaps = r["route_gaps"]
    job.readings["route_gap_max"] = float(gaps.max()) if gaps.numel() \
        else 0.0
    job.readings["route_decisions"] = sum(
        len(s) for s in seqs) * len(moe_layers)
    job.say(f"[check] topic LM: {len(seqs)} sequences, "
            f"{sum(len(s) for s in seqs)} tokens, route ties "
            f"{r['route_ties']}, reference {time.perf_counter() - t0:.2f} s")
    return out
