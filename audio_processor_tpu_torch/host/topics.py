"""Zero-shot topic classification via AWS Bedrock Claude, or on the
card with a local LM.

Behavior-matched to the reference's TopicClassifier
(services/topics_inf.py:28-305): French summary (<=120 words) of the
Darija transcript, then constrained single-number classification
against the numbered topic catalogue loaded from the B2C/B2B xlsx
glossaries (sheet "explication"). Unlike the reference, the call site
is actually wired into call aggregation (pipeline/sentiment.py); the
reference stubs it to '' (sentiment_analysis.py:432-435).

``topic_backend: bedrock`` (the default): one remote call per request;
disabled (``enabled=False``) without AWS credentials or boto3.

``topic_backend: local``: the same two prompts answered by a decoder-only
MoE LM on the analyzers' device (``models/moe_lm.py``, Moonlight-16B-A3B's
or, with ``model_type: kimi_linear`` and Kimi's own keys, the
Kimi-Linear-48B-A3B hybrid's widths from ``topic_model``), greedy, for
a whole analysis batch at once (:meth:`TopicClassifier.infer_batch`, span
``topics.batch``): one ragged
prefill and decode of every call's summary prompt, then of every
classification prompt. A prompt is ``bos``, the user marker, the prompt's
ids and the assistant marker (the model's chat template waits for its
tokenizer files); ids come from a seeded piece table with byte fallback
(``models/pieces.py``, ``topic_vocab_seed``) and the weights are seeded
stand-ins (bf16 on a CUDA device, fp32 elsewhere) until the checkpoint is
in the repository. Disabled without a glossary, as the Bedrock backend
is.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

SUMMARY_PROMPT = (
    "Tu es un expert du service client télécom.\n"
    "Lis la transcription (en darija) et rédige un **résumé en français** "
    "de 120 mots maximum incluant :\n"
    "• la raison de l'appel\n"
    "• les actions demandées ou proposées\n"
    "• les offres/services mentionnés\n\n"
    "Transcription :\n{transcript}\n\nRésumé :"
)

CLASSIFICATION_HEADER = (
    "Tu es un analyste expert du service client télécom.\n"
    "Voici la liste complète des sujets possibles, chacun identifié par "
    "un numéro :\n{topics}\n\nD'après le texte ci-dessous, réponds "
    "STRICTEMENT par le numéro du sujet le plus pertinent (un seul "
    "numéro, aucun autre texte).\n"
)


def _load_topics_xlsx(path: str) -> Optional[Dict[str, Any]]:
    """Catalogue from sheet 'explication': Catégorie / Type de
    spécialité / Explication (reference: topics_inf.py:77-98)."""
    from audio_processor_tpu_torch.host.xlsx import read_table

    table = read_table(path, sheet_name="explication")
    required = ["Catégorie", "Type de spécialité", "Explication"]
    if not all(c in table for c in required):
        logger.error("Glossary %s missing columns %s", path, required)
        return None
    n = len(table["Catégorie"])
    rows = []
    for i in range(n):
        cat = str(table["Catégorie"][i] or "").strip()
        typ = str(table["Type de spécialité"][i] or "").strip()
        expl = str(table["Explication"][i] or "").strip()
        rows.append((cat, typ, expl))
    topic_strs = [f"{c} – {t} : {e}" for c, t, e in rows]
    return {
        "rows": rows,
        "topic_lines": [f"{i+1}. {t}" for i, t in enumerate(topic_strs)],
        "topic_lookup": dict(enumerate(topic_strs, start=1)),
    }


# Reserved ids of the local LM's table beside bos and eos (Moonlight's
# tiktoken specials <|im_user|> and <|im_assistant|>; assumed).
USER_TOKEN_ID = 163587
ASSISTANT_TOKEN_ID = 163588
NOT_AVAILABLE = ("Service non disponible", "Appel blanc", "Non classifié")
CONFIG_ERROR = ("Erreur de configuration", "Appel blanc", "Non classifié")
FAILED = ("Erreur", "Appel blanc", "Erreur")


def _category(topics: Optional[Dict[str, Any]],
              idx_str: str) -> Tuple[str, str]:
    """(category, type) of a catalogue's topic number ``idx_str``."""
    if topics is None:
        return "UNKNOWN", "UNKNOWN"
    try:
        idx = int(idx_str)
        rows = topics["rows"]
        if 1 <= idx <= len(rows):
            cat, typ, _ = rows[idx - 1]
            return cat, typ
        logger.warning("Invalid topic index: %s", idx)
        return "UNKNOWN", "UNKNOWN"
    except (ValueError, IndexError) as e:
        logger.error("Error mapping index %s: %s", idx_str, e)
        return "UNKNOWN", "UNKNOWN"


class LocalLM:
    """The local backend's model and piece table: ``generate`` answers a
    batch of prompts (text) greedily with at most ``max_new`` tokens
    each."""

    def __init__(self, config, device="cuda", model=None, vocab=None):
        from audio_processor_tpu_torch.models import moe_lm
        from audio_processor_tpu_torch.models.pieces import PieceVocab

        spec = dict(config.get("topic_model") or {})
        self.cfg = moe_lm.MoELMConfig.from_dict(spec)
        cfg = self.cfg
        self.user_id = int(spec.get("user_token_id", USER_TOKEN_ID))
        self.assistant_id = int(spec.get("assistant_token_id",
                                         ASSISTANT_TOKEN_ID))
        special = (cfg.bos_token_id, cfg.eos_token_id, self.user_id,
                   self.assistant_id)
        if not all(0 <= i < cfg.vocab_size for i in special):
            raise ValueError(f"topic_model's special ids {special} must lie "
                             f"below its vocab_size {cfg.vocab_size}")
        if vocab is None:
            vocab = PieceVocab.synthetic_bytes(
                cfg.vocab_size, int(config.get("topic_vocab_seed", 0)),
                {cfg.bos_token_id: "[BOS]", cfg.eos_token_id: "[EOS]",
                 self.user_id: "<|im_user|>",
                 self.assistant_id: "<|im_assistant|>"})
        if model is None:
            import torch

            device = torch.device(device)
            model = moe_lm.build_synthetic(
                cfg, device, 0, torch.bfloat16 if device.type == "cuda"
                else torch.float32)
        self.vocab = vocab
        self.model = model

    def prompt_ids(self, text: str) -> List[int]:
        cfg = self.cfg
        return ([cfg.bos_token_id, self.user_id] + self.vocab.encode(text)
                + [self.assistant_id])

    def fits(self, ids: Sequence[int], max_new: int) -> bool:
        return len(ids) + max_new - 1 <= self.cfg.positions

    def generate(self, prompts: List[List[int]], max_new: int,
                 kind: str) -> List[str]:
        """Each prompt's greedy answer, decoded up to its eos."""
        import torch

        with torch.inference_mode():
            out = self.model.generate(prompts, max_new, kind)
        ids = out["ids"]
        return [self.vocab.decode(ids[r, :out["emitted"][r]])
                for r in range(len(prompts))]


class TopicClassifier:
    def __init__(self, config, client=None, device="cuda", local=None):
        self.config = config
        self.enabled = False
        self._client = client
        self.backend = str(config.get("topic_backend", "bedrock"))
        self.local: Optional[LocalLM] = None
        if self.backend == "local":
            self.local = local or LocalLM(config, device)
        elif self.backend != "bedrock":
            raise ValueError(f"topic_backend {self.backend!r}: expected "
                             "'bedrock' or 'local'")
        elif client is None:
            if not (os.getenv("AWS_ACCESS_KEY_ID")
                    and os.getenv("AWS_SECRET_ACCESS_KEY")):
                logger.warning("AWS credentials not configured - "
                               "topic classification disabled")
                return
            try:
                import boto3

                self._client = boto3.client(
                    "bedrock-runtime",
                    region_name=os.getenv(
                        "AWS_DEFAULT_REGION",
                        config.get("bedrock_region", "us-west-2")),
                    aws_access_key_id=os.getenv("AWS_ACCESS_KEY_ID"),
                    aws_secret_access_key=os.getenv("AWS_SECRET_ACCESS_KEY"))
            except ImportError:
                logger.warning("boto3 not installed - topic "
                               "classification disabled")
                return
        self.b2c_topics = self._safe_load("topics_glossary_b2c")
        self.b2b_topics = self._safe_load("topics_glossary_b2b")
        self.enabled = (self.b2c_topics is not None
                        or self.b2b_topics is not None)
        self._active: Optional[Dict[str, Any]] = None
        if self.enabled:
            logger.info("Topic classifier initialized")

    def _safe_load(self, key: str) -> Optional[Dict[str, Any]]:
        path = self.config.get(key, "")
        if not path or not Path(path).exists():
            return None
        try:
            return _load_topics_xlsx(path)
        except Exception as e:
            logger.error("Error loading %s: %s", key, e)
            return None

    # ------------------------------------------------------------------
    def _invoke_model(self, model_id: str, body: dict,
                      attempts: int = 5) -> dict:
        """Bedrock invoke with exponential retry
        (reference: topics_inf.py:146-155)."""
        delay = 0.0
        last = None
        for attempt in range(attempts):
            try:
                response = self._client.invoke_model(
                    modelId=model_id,
                    body=json.dumps(body).encode("utf-8"),
                    accept="application/json",
                    contentType="application/json")
                return json.loads(response["body"].read())
            except Exception as e:  # pragma: no cover - network
                last = e
                time.sleep(min(1.0, delay))
                delay = delay * 2 if delay else 0.125
        raise last

    @property
    def batched(self) -> bool:
        """Whether :meth:`infer_batch` answers a batch at once (the local
        backend) rather than request by request."""
        return self.local is not None

    def summarize(self, transcript: str) -> str:
        if not self.enabled:
            return "Service de résumé non disponible"
        try:
            body = {
                "anthropic_version": "bedrock-2023-05-31",
                "max_tokens": self.config.get("max_tokens_summary", 300),
                "temperature": self.config.get("temperature", 0.0),
                "messages": [{"role": "user", "content":
                              SUMMARY_PROMPT.format(transcript=transcript)}],
            }
            data = self._invoke_model(
                self.config.get("summary_model_id"), body)
            return data["content"][0]["text"].strip()
        except Exception as e:
            logger.error("Summarization failed: %s", e)
            return "Erreur lors du résumé"

    def classify(self, summary_text: str) -> str:
        if not self.enabled or self._active is None:
            return "0"
        try:
            header = CLASSIFICATION_HEADER.format(
                topics="\n".join(self._active["topic_lines"]))
            body = {
                "anthropic_version": "bedrock-2023-05-31",
                "max_tokens": self.config.get("max_tokens_class", 3),
                "temperature": self.config.get("temperature", 0.0),
                "messages": [{"role": "user", "content":
                              f"{header}\nTexte :\n{summary_text}\n"
                              "Numéro :"}],
            }
            data = self._invoke_model(self.config.get("class_model_id"),
                                      body)
            return data["content"][0]["text"].strip()
        except Exception as e:
            logger.error("Classification failed: %s", e)
            return "0"

    def map_index_to_category(self, idx_str: str) -> Tuple[str, str]:
        return _category(self._active, idx_str)

    @staticmethod
    def clean_summary(summary: str) -> str:
        """Strip common prefixes (reference: topics_inf.py:251-269)."""
        summary = re.sub(r"^[^:]*:\s*", "", summary, count=1)
        summary = re.sub(
            r"(?i)^résumé\s+en\s+français\s*\([^)]+\)\s*:\s*",
            "", summary, count=1)
        return summary.strip()

    def _set_active_topics(self, business_type: str) -> bool:
        data = (self.b2c_topics if business_type == "B2C"
                else self.b2b_topics)
        if data is None:
            logger.error("No topics loaded for %s", business_type)
            self._active = None
            return False
        self._active = data
        return True

    def _topics(self, business_type: str) -> Optional[Dict[str, Any]]:
        return self.b2c_topics if business_type == "B2C" \
            else self.b2b_topics

    def infer_batch(self, transcriptions: Sequence[str],
                    business_types: Sequence[str]
                    ) -> List[Tuple[str, str, str]]:
        """(summary, category, type) of each call, as :meth:`infer` gives
        them; the local backend answers the batch at once (span
        ``topics.batch``), the Bedrock one call by call. A failure of the
        local LM raises: no row of the batch gets an answer it did not
        compute."""
        if self.local is None or not self.enabled:
            return [self.infer(t, b)
                    for t, b in zip(transcriptions, business_types)]
        from audio_processor_tpu_torch.obs import profiler

        lm = self.local
        n_sum = int(self.config.get("max_tokens_summary", 300))
        n_cls = int(self.config.get("max_tokens_class", 3))
        out: List[Tuple[str, str, str]] = [FAILED] * len(transcriptions)
        with profiler.span("topics.batch", calls=len(transcriptions)):
            rows, prompts = [], []
            for i, (text, bt) in enumerate(zip(transcriptions,
                                               business_types)):
                if self._topics(bt) is None:
                    logger.error("No topics loaded for %s", bt)
                    out[i] = CONFIG_ERROR
                    continue
                ids = lm.prompt_ids(SUMMARY_PROMPT.format(transcript=text))
                if not lm.fits(ids, n_sum):
                    logger.error(
                        "Topic prompt of %d tokens refused: with %d new "
                        "tokens it needs more than the model's %d "
                        "positions", len(ids), n_sum,
                        lm.cfg.positions)
                    continue
                rows.append(i)
                prompts.append(ids)
            if not rows:
                return out
            summaries = lm.generate(prompts, n_sum, "summary")
            keep, prompts = [], []
            for i, summary in zip(rows, summaries):
                topics = self._topics(business_types[i])
                header = CLASSIFICATION_HEADER.format(
                    topics="\n".join(topics["topic_lines"]))
                ids = lm.prompt_ids(f"{header}\nTexte :\n{summary}\n"
                                    "Numéro :")
                out[i] = (self.clean_summary(summary), "UNKNOWN", "UNKNOWN")
                if lm.fits(ids, n_cls):
                    keep.append(i)
                    prompts.append(ids)
                else:
                    logger.error("Classification prompt of %d tokens "
                                 "refused", len(ids))
                    out[i] = FAILED
            if keep:
                answers = lm.generate(prompts, n_cls, "class")
                for i, idx in zip(keep, answers):
                    cat, typ = _category(self._topics(business_types[i]),
                                         idx.strip())
                    out[i] = (out[i][0], cat, typ)
        return out

    def infer(self, transcription: str, business_type: str = "B2C"
              ) -> Tuple[str, str, str]:
        if not self.enabled:
            return NOT_AVAILABLE
        if self.local is not None:
            return self.infer_batch([transcription], [business_type])[0]
        try:
            if not self._set_active_topics(business_type):
                return ("Erreur de configuration", "Appel blanc",
                        "Non classifié")
            summary = self.summarize(transcription)
            summary_cleaned = self.clean_summary(summary)
            idx = self.classify(summary)
            category, type_specialty = self.map_index_to_category(idx)
            return summary_cleaned, category, type_specialty
        except Exception as e:
            logger.error("Inference failed: %s", e)
            return "Erreur", "Appel blanc", "Erreur"
