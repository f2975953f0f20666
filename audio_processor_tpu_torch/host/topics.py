"""Zero-shot topic classification via AWS Bedrock Claude.

Behavior-matched to the reference's TopicClassifier
(services/topics_inf.py:28-305): French summary (<=120 words) of the
Darija transcript, then constrained single-number classification
against the numbered topic catalogue loaded from the B2C/B2B xlsx
glossaries (sheet "explication"). Unlike the reference, the call site
is actually wired into call aggregation (pipeline/sentiment.py); the
reference stubs it to '' (sentiment_analysis.py:432-435).

Disabled (``enabled=False``) without AWS credentials or boto3.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

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


class TopicClassifier:
    def __init__(self, config, client=None):
        self.config = config
        self.enabled = False
        self._client = client
        if client is None:
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
        if self._active is None:
            return "UNKNOWN", "UNKNOWN"
        try:
            idx = int(idx_str)
            rows = self._active["rows"]
            if 1 <= idx <= len(rows):
                cat, typ, _ = rows[idx - 1]
                return cat, typ
            logger.warning("Invalid topic index: %s", idx)
            return "UNKNOWN", "UNKNOWN"
        except (ValueError, IndexError) as e:
            logger.error("Error mapping index %s: %s", idx_str, e)
            return "UNKNOWN", "UNKNOWN"

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

    def infer(self, transcription: str, business_type: str = "B2C"
              ) -> Tuple[str, str, str]:
        if not self.enabled:
            return "Service non disponible", "Appel blanc", "Non classifié"
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
