"""Multi-modal sentiment analysis (port of pipeline/sentiment.py).

Same coordinator, output keys and reference quirks as the JAX package:

- acoustic results are gated on a non-empty text prediction;
- all-zero or NaN scaled features yield empty acoustic results;
- SVC.predict (ovo voting) gives the label and predict_proba the
  confidence, and they can disagree;
- late fusion is a fixed weighted probability sum with the
  aggressive-demotion rule.

Text: the client and agent DarijaBERT-style classifiers
(models/bert.py) on the analyzers' device, ``cuda`` unless the caller
asks for another (as ``DataProcessor`` does; where there is no CUDA
device it raises and never falls back to the CPU). Checkpoints load from
their HF directories without ``transformers`` (models/hf_files.py,
models/convert_hf.py) and tokenize with the port's WordPiece tokenizer
(models/bert_tokenizer.py, the ids ``AutoTokenizer`` gives). Token
counts are padded to static length buckets and the batch to a multiple of
16, as in the reference; texts under 5 stripped characters are skipped.
``dispatch_batch`` enqueues a classifier and returns a fetch closure, so
the coordinator runs the agent and client classifiers before fetching
either.

The acoustic features normally arrive precomputed by the fused ASR
program; otherwise :meth:`AcousticSentimentAnalyzer.extract_features`
runs the port's torch extractor on the analyzer's device. The classifier
heads run on the host in numpy, as in the reference.
"""

from __future__ import annotations

import collections
import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from audio_processor_tpu_torch.dsp.acoustic_features import (
    extract_features_batch, prepare_reflect_padded,
)
from audio_processor_tpu_torch.host.aggregation import (
    aggregate_agent_sentiment, aggregate_client_sentiment,
    call_id_from_chunk_filename, pretty_sentiment,
)
from audio_processor_tpu_torch.models import bert as bert_mod
from audio_processor_tpu_torch.models import sklearn_infer as ski
from audio_processor_tpu_torch.models.bert_tokenizer import BertTokenizer
from audio_processor_tpu_torch.models.convert_hf import (
    convert_bert_classifier,
)
from audio_processor_tpu_torch.models.hf_files import (
    read_config, read_state_dict,
)
from audio_processor_tpu_torch.obs import profiler
from audio_processor_tpu_torch.pipeline.chunker import pick_bucket

logger = logging.getLogger(__name__)

EMPTY = {"prediction": "", "confidence": 0.0, "probabilities": []}


def _empty_results(n: int) -> List[Dict[str, Any]]:
    return [dict(EMPTY) for _ in range(n)]


# ----------------------------------------------------------------------
class TextSentimentAnalyzer:
    """Client/agent text classifiers, loaded when both paths are set."""

    # Token counts are padded to these buckets, so the classifiers run a
    # handful of shapes.
    _LEN_BUCKETS = (32, 64, 128, 256, 512)

    def __init__(self, config, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.models: Dict[str, Optional[Dict[str, Any]]] = {
            "client": None, "agent": None}
        self.models_available = False
        # (batch rows, bucket) of every classifier run, for the records.
        self.shapes_run: collections.Counter = collections.Counter()
        client_path = config.get("client_text_model_path", "")
        agent_path = config.get("agent_text_model_path", "")
        if client_path and agent_path:
            try:
                self.models["client"] = self._load_one(client_path)
                self.models["agent"] = self._load_one(agent_path)
                self.models_available = True
            except Exception as e:  # a bad checkpoint disables text
                logger.error("Failed to load text models: %s", e)
        else:
            logger.warning("Text model paths not configured - "
                           "text sentiment disabled")

    def _load_one(self, path: str) -> Dict[str, Any]:
        hf = read_config(path)
        cfg = bert_mod.BertConfig.from_hf(hf)
        id2label = ({int(k): v for k, v in hf["id2label"].items()}
                    if hf.get("id2label")
                    else {i: f"LABEL_{i}" for i in range(cfg.num_labels)})
        sd = convert_bert_classifier(read_state_dict(path),
                                     cfg.num_hidden_layers)
        with torch.device("meta"):
            model = bert_mod.BertForSequenceClassification(cfg)
        model.load_state_dict(sd, assign=True)
        model = model.to(self.device).eval()
        if str(self.config.get("quantization", "none")) == "int8":
            # The same opt-in W8A8 mode as the ASR encoder.
            model = bert_mod.quantize_model(model)
        return {"model": model, "cfg": cfg,
                "tokenizer": BertTokenizer.from_pretrained(path),
                "id2label": id2label}

    def _bucket_len(self, n: int) -> int:
        for b in self._LEN_BUCKETS:
            if n <= b:
                return b
        return self._LEN_BUCKETS[-1]

    def dispatch_batch(self, texts: Sequence[str], speaker: str):
        """Tokenize and enqueue the classifier on the device (CUDA runs
        asynchronously), and return a closure that fetches the results."""
        n = len(texts)
        if n == 0:
            return lambda: []
        model = (self.models.get(speaker)
                 if self.models_available else None)
        if model is None:
            return lambda: _empty_results(n)

        valid_idx = [i for i, t in enumerate(texts)
                     if t and t.strip() and len(t.strip()) >= 5]
        if not valid_idx:
            return lambda: _empty_results(n)
        enc = model["tokenizer"]([texts[i] for i in valid_idx],
                                 max_length=512)
        ids = enc["input_ids"].astype(np.int32)
        mask = enc["attention_mask"].astype(np.float32)
        L = self._bucket_len(ids.shape[1])
        if ids.shape[1] < L:
            pad = L - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, pad)))
            mask = np.pad(mask, ((0, 0), (0, pad)))
        # The batch padded to a multiple of 16 (static shapes).
        nvalid = ids.shape[0]
        pad_b = max(16, -(-nvalid // 16) * 16) - nvalid
        if pad_b:
            ids = np.pad(ids, ((0, pad_b), (0, 0)))
            mask = np.pad(mask, ((0, pad_b), (0, 0)))
        with torch.inference_mode():
            device_probs = torch.softmax(model["model"](
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device)), dim=-1)
        self.shapes_run[ids.shape] += 1

        def fetch() -> List[Dict[str, Any]]:
            probs = device_probs.cpu().numpy()[:nvalid]
            id2label = model["id2label"]
            out = _empty_results(n)
            for row, i in enumerate(valid_idx):
                p = probs[row]
                idx = int(np.argmax(p))
                out[i] = {"prediction": id2label.get(idx, "unknown"),
                          "confidence": float(p.max()),
                          "probabilities": p.tolist()}
            return out
        return fetch

    def analyze_batch_sentiment(self, texts: Sequence[str],
                                speaker: str) -> List[Dict[str, Any]]:
        return self.dispatch_batch(texts, speaker)()

    def analyze_sentiment(self, text: str, speaker: str) -> Dict[str, Any]:
        return self.analyze_batch_sentiment([text], speaker)[0]


# ----------------------------------------------------------------------
class AcousticSentimentAnalyzer:
    """SVM (client) / RandomForest (agent) on 38-dim acoustic features."""

    def __init__(self, config, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.models: Dict[str, Optional[Dict[str, Any]]] = {
            "client": None, "agent": None}
        self.models_available = False
        paths = [config.get(k, "") for k in (
            "client_acoustic_model_path", "client_acoustic_scaler_path",
            "agent_acoustic_model_path", "agent_acoustic_scaler_path")]
        if all(paths):
            try:
                self.models["client"] = self._load_one(paths[0], paths[1])
                self.models["agent"] = self._load_one(paths[2], paths[3])
                self.models_available = True
            except Exception as e:
                logger.error("Failed to load acoustic models: %s", e)
        else:
            logger.warning("Acoustic model paths not configured - "
                           "acoustic sentiment disabled")
        self.client_acoustic_id2label = self._id2label("client")
        self.agent_acoustic_id2label = self._id2label("agent")

    def _id2label(self, speaker: str) -> Dict[int, Any]:
        m = self.models.get(speaker)
        if not m:
            return {}
        return {i: c for i, c in enumerate(m["classes"])}

    def _load_one(self, model_path: str, scaler_path: str) -> Dict[str, Any]:
        import joblib

        skl_model = joblib.load(model_path)
        scaler = joblib.load(scaler_path)
        entry: Dict[str, Any] = {
            "scaler": ski.convert_scaler(scaler),
            "n_features": int(scaler.n_features_in_),
            "classes": np.asarray(skl_model.classes_),
        }
        if hasattr(skl_model, "support_vectors_"):
            entry["kind"] = "svc"
            entry["model"] = ski.convert_svc(skl_model)
        else:
            entry["kind"] = "forest"
            entry["model"] = ski.convert_forest(skl_model)
        return entry

    def extract_features(self, waveforms: Sequence[Optional[np.ndarray]],
                         bucket_len: int) -> np.ndarray:
        """Batched 38-dim feature extraction on the analyzer's device
        (batch padded to a multiple of 16, as in the reference)."""
        waves = [np.zeros(0, np.float32) if w is None else
                 np.asarray(w, np.float32).reshape(-1) for w in waveforms]
        n = len(waves)
        pad_to = max(16, -(-n // 16) * 16)
        waves = waves + [np.zeros(0, np.float32)] * (pad_to - n)
        buf, lengths = prepare_reflect_padded(waves, bucket_len)
        with torch.inference_mode():
            feats = extract_features_batch(
                torch.from_numpy(buf).to(self.device),
                torch.from_numpy(lengths).to(self.device))
        return feats.cpu().numpy()[:n]

    def analyze_batch_sentiment(self, waveforms: Sequence[Any],
                                sample_rate: int, speaker: str
                                ) -> List[Dict[str, Any]]:
        n = len(waveforms)
        if n == 0:
            return []
        if not self.models_available or self.models.get(speaker) is None:
            return _empty_results(n)
        waves, valid = [], []
        for i, w in enumerate(waveforms):
            if w is None:
                continue
            arr = np.asarray(w, np.float32).reshape(-1)
            if arr.size == 0:
                continue
            waves.append(arr)
            valid.append(i)
        if not waves:
            return _empty_results(n)
        buckets = tuple(int(b * sample_rate) for b in self.config.get(
            "length_buckets_sec", (5.0, 10.0, 15.0, 20.0, 25.0)))
        bucket = pick_bucket(max(w.shape[0] for w in waves), buckets)
        results = self.classify_features(
            self.extract_features(waves, bucket), speaker)
        final = _empty_results(n)
        for row, i in enumerate(valid):
            final[i] = results[row]
        return final

    def classify_features(self, feats: np.ndarray, speaker: str
                          ) -> List[Dict[str, Any]]:
        """Classify precomputed 38-dim feature rows (the fused ASR
        program computes them alongside transcription)."""
        entry = self.models.get(speaker)
        n = feats.shape[0]
        if entry is None or not self.models_available:
            return _empty_results(n)
        feats = np.asarray(feats, np.float32)
        nf = entry["n_features"]
        if feats.shape[1] < nf:
            feats = np.pad(feats, ((0, 0), (0, nf - feats.shape[1])))
        elif feats.shape[1] > nf:
            feats = feats[:, :nf]

        scaled = ski.scaler_transform_np(entry["scaler"], feats)
        ok = ~(np.all(scaled == 0, axis=1) | np.isnan(scaled).any(axis=1))
        # NaN rows are masked out of the results; compute on zeroed copies.
        safe = np.where(np.isnan(scaled), 0.0, scaled).astype(np.float32)
        if entry["kind"] == "svc":
            pred_idx = ski.svc_predict_np(entry["model"], safe)
            probas = ski.svc_predict_proba_np(entry["model"], safe)
        else:
            probas = ski.forest_predict_proba_np(entry["model"], safe)
            pred_idx = np.argmax(probas, axis=-1)
        classes = entry["classes"]

        out = _empty_results(n)
        for row in range(n):
            if not ok[row]:
                continue
            p = probas[row]
            out[row] = {
                "prediction": classes[int(pred_idx[row])],
                "confidence": float(p.max()),
                "probabilities": p.tolist(),
            }
        return out

    def analyze_sentiment(self, waveform, sample_rate: int,
                          speaker: str) -> Dict[str, Any]:
        return self.analyze_batch_sentiment([waveform], sample_rate,
                                            speaker)[0]


# ----------------------------------------------------------------------
class LateFusionSentimentAnalyzer:
    """Weighted probability fusion."""

    CLIENT_TEXT_W, CLIENT_ACOUSTIC_W = 0.42, 0.58
    AGENT_TEXT_W, AGENT_ACOUSTIC_W = 0.54, 0.46

    def __init__(self, config=None):
        self.agent_id2label: Dict[int, Any] = {}
        self.client_id2label: Dict[int, Any] = {}

    def analyze_sentiment(self, results: Dict[str, Any],
                          speaker: str) -> Dict[str, Any]:
        text_sentiment = results.get(f"{speaker}_text_sentiment", "")
        acoustic_sentiment = results.get(f"{speaker}_acoustic_sentiment", "")
        text_confidence = results.get(f"{speaker}_text_confidence", 0.0)
        acoustic_confidence = results.get(
            f"{speaker}_acoustic_confidence", 0.0)
        text_probs = results.get(f"{speaker}_text_probabilities", [])
        acoustic_probs = results.get(f"{speaker}_acoustic_probabilities", [])

        has_both = (text_sentiment != "" and acoustic_sentiment != ""
                    and len(text_probs) > 0 and len(acoustic_probs) > 0)
        if not has_both:
            if text_sentiment:
                return {"prediction": text_sentiment,
                        "confidence": text_confidence,
                        "probabilities": text_probs}
            if acoustic_sentiment:
                return {"prediction": acoustic_sentiment,
                        "confidence": acoustic_confidence,
                        "probabilities": acoustic_probs}
            return dict(EMPTY)

        tp = np.asarray(text_probs, np.float64)
        ap = np.asarray(acoustic_probs, np.float64)
        if speaker == "client":
            fused = self.CLIENT_TEXT_W * tp + self.CLIENT_ACOUSTIC_W * ap
            id2label = self.client_id2label
        else:
            fused = self.AGENT_TEXT_W * tp + self.AGENT_ACOUSTIC_W * ap
            id2label = self.agent_id2label

        idx = int(np.argmax(fused))
        conf = float(np.max(fused))
        prediction = id2label.get(idx, "unknown")

        if speaker != "client" and prediction == "aggressive":
            # Aggressive-demotion rule.
            if conf < 0.7 and (text_sentiment != "aggressive"
                               or text_confidence < 0.8):
                for alt in np.argsort(fused)[::-1][1:]:
                    alt_label = id2label.get(int(alt), "unknown")
                    if alt_label not in ("aggressive", "agressif"):
                        prediction = alt_label
                        conf = float(fused[int(alt)])
                        break
        return {"prediction": prediction, "confidence": conf,
                "probabilities": fused.tolist()}


# ----------------------------------------------------------------------
class SentimentAnalyzer:
    """Coordinator; the JAX package's public API and output keys."""

    def __init__(self, config, db_manager=None, topic_classifier=None,
                 device="cuda"):
        self.config = config
        self.db_manager = db_manager
        self.device = torch.device(device)
        self.topic_classifier = topic_classifier
        self.load_models()

    def set_database_manager(self, db_manager):
        self.db_manager = db_manager

    def load_models(self):
        """(Re)build the three analyzers."""
        self.text_analyzer = TextSentimentAnalyzer(self.config, self.device)
        self.acoustic_analyzer = AcousticSentimentAnalyzer(self.config,
                                                           self.device)
        self.late_fusion_analyzer = LateFusionSentimentAnalyzer(self.config)
        self.late_fusion_analyzer.agent_id2label = \
            self.acoustic_analyzer.agent_acoustic_id2label
        self.late_fusion_analyzer.client_id2label = \
            self.acoustic_analyzer.client_acoustic_id2label

    def pretty_sentiment(self, label) -> str:
        """Raw label -> display variant."""
        return pretty_sentiment(label)

    # ------------------------------------------------------------------
    def analyze_batch_sentiment(self, chunks: List[Dict]) -> List[Dict]:
        if not chunks:
            return chunks
        try:
            results = self._analyze_batch(chunks)
            for i, chunk in enumerate(chunks):
                chunk.update(results[i])
        except Exception as e:
            logger.error("Error in batch sentiment analysis: %s", e)
            return self._fallback_individual_processing(chunks)
        self._persist(chunks, self._batch_topics(chunks))
        return chunks

    def _analyze_batch(self, chunks: List[Dict]) -> List[Dict]:
        sr = int(self.config.get("target_sample_rate", 16000))
        # Both classifiers are dispatched before either is fetched, so the
        # two programs queue back to back on the device.
        with profiler.span("sentiment.text", chunks=len(chunks)):
            a_fetch = self.text_analyzer.dispatch_batch(
                [c.get("agent_transcription", "") for c in chunks], "agent")
            c_fetch = self.text_analyzer.dispatch_batch(
                [c.get("client_transcription", "") for c in chunks],
                "client")
            a_text = a_fetch()
            c_text = c_fetch()

        def acoustic(speaker):
            # Prefer the features the fused ASR program computed.
            feats = [c.get(f"{speaker}_acoustic_features") for c in chunks]
            if all(f is not None for f in feats):
                return self.acoustic_analyzer.classify_features(
                    np.stack(feats), speaker)
            return self.acoustic_analyzer.analyze_batch_sentiment(
                [c.get(f"{speaker}_waveform") for c in chunks], sr,
                speaker)

        with profiler.span("sentiment.acoustic", chunks=len(chunks)):
            a_ac = acoustic("agent")
            c_ac = acoustic("client")

        out = []
        with profiler.span("sentiment.fusion", chunks=len(chunks)):
            for i in range(len(chunks)):
                r: Dict[str, Any] = {}
                for speaker, t, a in (("agent", a_text[i], a_ac[i]),
                                      ("client", c_text[i], c_ac[i])):
                    gate = t.get("prediction", "") != ""
                    r.update({
                        f"{speaker}_text_sentiment": t.get("prediction", ""),
                        f"{speaker}_text_confidence": t.get("confidence", 0.0),
                        f"{speaker}_text_probabilities":
                            t.get("probabilities", []),
                        f"{speaker}_acoustic_sentiment":
                            a.get("prediction", "") if gate else "",
                        f"{speaker}_acoustic_confidence":
                            a.get("confidence", 0.0) if gate else 0.0,
                        f"{speaker}_acoustic_probabilities":
                            a.get("probabilities", []) if gate else [],
                    })
                af = self.late_fusion_analyzer.analyze_sentiment(r, "agent")
                cf = self.late_fusion_analyzer.analyze_sentiment(r, "client")
                r.update({
                    "agent_fusion_sentiment": af.get("prediction", ""),
                    "agent_fusion_confidence": af.get("confidence", 0.0),
                    "client_fusion_sentiment": cf.get("prediction", ""),
                    "client_fusion_confidence": cf.get("confidence", 0.0),
                })
                out.append(r)
        return out

    def _fallback_individual_processing(self, chunks: List[Dict]
                                        ) -> List[Dict]:
        """Per-chunk degradation when batch analysis fails."""
        logger.warning("Falling back to individual chunk processing")
        for chunk in chunks:
            try:
                chunk.update(self._analyze_batch([chunk])[0])
            except Exception as e:
                logger.error("Error analyzing sentiment for %s: %s",
                             chunk.get("file_name", "unknown"), e)
                chunk.update({
                    f"{speaker}_{kind}_{field}":
                        "error" if field == "sentiment" else 0.0
                    for speaker in ("agent", "client")
                    for kind in ("text", "acoustic", "fusion")
                    for field in ("sentiment", "confidence")})
                chunk["sentiment_error"] = str(e)
        self._persist(chunks)
        return chunks

    # ------------------------------------------------------------------
    @staticmethod
    def _per_call(chunks: List[Dict]) -> Dict[str, List[Dict]]:
        per_call: Dict[str, List[Dict]] = {}
        for chunk in chunks:
            filename = chunk.get("file_name", "")
            if not filename:
                continue
            call_id = call_id_from_chunk_filename(
                filename, chunk.get("chunk_idx", chunk.get("chunk_index")))
            per_call.setdefault(call_id, []).append(chunk)
        return per_call

    def _business_type(self, call_id: str) -> str:
        try:
            return self.db_manager.get_business_type(call_id) or "B2C"
        except Exception:
            return "B2C"

    def _batch_topics(self, chunks: List[Dict]) -> Optional[Dict[str, str]]:
        """One topic pass over every call of the batch, before persistence
        and outside its spans, when the classifier answers a batch at once
        (the local backend): call id -> ``"category - type"``, or ``""``
        for every call when the pass fails. None otherwise: the aggregates
        then ask call by call."""
        tc = self.topic_classifier
        if not self.db_manager or tc is None \
                or not getattr(tc, "enabled", False) \
                or not getattr(tc, "batched", False):
            return None
        per_call = self._per_call(chunks)
        ids = list(per_call)
        try:
            answers = tc.infer_batch(
                ["".join(it.get("transcription_chunk", "")
                         for it in per_call[c]) for c in ids],
                [self._business_type(c) for c in ids])
        except Exception as e:
            logger.error("Topic inference failed: %s", e)
            return {c: "" for c in ids}
        return {c: f"{cat} - {typ}" for c, (_, cat, typ) in zip(ids, answers)}

    def _persist(self, chunks: List[Dict],
                 topics: Optional[Dict[str, str]] = None) -> None:
        if not self.db_manager:
            return
        with profiler.span("engine.persist", what="chunks"):
            self._save_chunks_to_database(chunks)
        try:
            with profiler.span("engine.persist", what="aggregates"):
                self._update_calls_aggregated_emotions(chunks, topics)
        except Exception as e:
            logger.error("Failed to update call-level emotions: %s", e)

    def _save_chunks_to_database(self, chunks: List[Dict]):
        for chunk in chunks:
            filename = chunk.get("file_name", "")
            if not filename:
                continue
            call_id = call_id_from_chunk_filename(
                filename, chunk.get("chunk_idx", chunk.get("chunk_index")))
            try:
                existing = self.db_manager.get_call_by_id_enregistrement(
                    call_id)
            except Exception:
                existing = None
            if not existing:
                try:
                    self.db_manager.insert_call({
                        "id_enregistrement": call_id,
                        "duration_seconds": None,
                        "topics": "",
                        "emotion_client_globale": "",
                        "ton_agent_global": "",
                    })
                except Exception as e:
                    logger.error("Failed to create call %s: %s", call_id, e)
                    continue
            try:
                self.db_manager.insert_chunk({
                    "id_chunk": f"{chunk.get('chunk_idx', 0)}",
                    "id_enregistrement": call_id,
                    "transcription_chunk":
                        chunk.get("transcription_chunk", ""),
                    "transcription_agent":
                        chunk.get("agent_transcription", ""),
                    "transcription_client":
                        chunk.get("client_transcription", ""),
                    "emotion_client": chunk.get("client_fusion_sentiment", ""),
                    "ton_agent": chunk.get("agent_fusion_sentiment", ""),
                })
            except Exception as e:
                logger.error("Failed to insert chunk for %s: %s", call_id, e)

    def _update_calls_aggregated_emotions(
            self, chunks: List[Dict],
            batch_topics: Optional[Dict[str, str]] = None):
        """Call-level emotions and topics; ``batch_topics`` (call id ->
        topics) holds what a batched topic pass already gave."""
        for call_id, items in self._per_call(chunks).items():
            client_emotion = aggregate_client_sentiment(
                [str(it.get("client_fusion_sentiment", "") or "")
                 for it in items])
            agent_ton = aggregate_agent_sentiment(
                [str(it.get("agent_fusion_sentiment", "") or "")
                 for it in items])
            if batch_topics is not None and call_id in batch_topics:
                topics = batch_topics[call_id]
            else:
                topics = self.sentiment_appel_topics(
                    items, self._business_type(call_id))
            if client_emotion or agent_ton:
                try:
                    self.db_manager.update_call_sentiment(
                        call_id, client_emotion, agent_ton, topics)
                except Exception as e:
                    logger.error("Call sentiment update failed for %s: %s",
                                 call_id, e)

    def sentiment_appel_topics(self, items: List[Dict],
                               business_type: str = "B2C") -> str:
        """Call-level topic classification via the topic classifier,
        when one with credentials is present."""
        if self.topic_classifier is None or \
                not getattr(self.topic_classifier, "enabled", False):
            return ""
        transcription = "".join(
            it.get("transcription_chunk", "") for it in items)
        try:
            _, cat, typ = self.topic_classifier.infer(
                transcription, business_type)
            return f"{cat} - {typ}"
        except Exception as e:
            logger.error("Topic inference failed: %s", e)
            return ""
