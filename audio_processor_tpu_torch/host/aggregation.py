"""Call-level sentiment aggregation business rules.

Pure-function port of the priority-ordered rules in the reference
(reference: services/sentiment_analysis.py:437-528). These rules are
business behavior, not incidental implementation, so they are kept
bit-for-bit:

Client (sentiment_analysis.py:444-485):
  1. last chunk == "Content"            -> "Content"
  2. any "Très Mécontent"               -> "Très Mécontent"
  3. any "Mécontent"                    -> "Mécontent"
  4. >=50% "Neutre"                     -> "Neutre"
  5. otherwise most common of the four candidate labels

Agent (sentiment_analysis.py:487-528):
  1. any "Agressif"                     -> "Agressif"
  2. last == "Sec" or >=30% "Sec"       -> "Sec"
  3. last == "Courtois" and >=50%       -> "Courtois"
  4. last == "Neutre" and no "Sec"      -> "Neutre"
  5. otherwise most common of the four candidate labels
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional

# Raw model label -> display label (sentiment_analysis.py:37-48).
SENTIMENT_DISPLAY = {
    "content": "Content",
    "mécontent": "Mécontent",
    "mecontent": "Mécontent",
    "tres mecontent": "Très Mécontent",
    "très mécontent": "Très Mécontent",
    "neutre": "Neutre",
    "aggressive": "Agressif",
    "agressif": "Agressif",
    "sec": "Sec",
    "courtois": "Courtois",
}

CLIENT_CANDIDATES = ["Content", "Mécontent", "Très Mécontent", "Neutre"]
AGENT_CANDIDATES = ["Agressif", "Sec", "Courtois", "Neutre"]


def pretty_sentiment(label: Optional[str]) -> str:
    """Display mapping with capitalize fallback (sentiment_analysis.py:437-442)."""
    if label is None:
        return "Vide"
    key = str(label).strip().lower()
    return SENTIMENT_DISPLAY.get(key, str(label).capitalize())


def _normalize(sentiments: List[str]) -> List[str]:
    return [pretty_sentiment(s.strip()) for s in sentiments if s and s.strip()]


def aggregate_client_sentiment(sentiments: List[str]) -> str:
    if not sentiments:
        return "Inconnu"
    sentiments = _normalize(sentiments)
    if not sentiments:
        return "Inconnu"

    count = Counter(sentiments)
    total = len(sentiments)

    if sentiments[-1] == "Content":
        return "Content"
    if "Très Mécontent" in count:
        return "Très Mécontent"
    if "Mécontent" in count:
        return "Mécontent"
    if count.get("Neutre", 0) / total >= 0.5:
        return "Neutre"
    return max(CLIENT_CANDIDATES, key=lambda x: count.get(x, 0))


def aggregate_agent_sentiment(sentiments: List[str]) -> str:
    if not sentiments:
        return "Inconnu"
    sentiments = _normalize(sentiments)
    if not sentiments:
        return "Inconnu"

    count = Counter(sentiments)
    total = len(sentiments)

    if "Agressif" in count:
        return "Agressif"
    if sentiments[-1] == "Sec" or count.get("Sec", 0) / total >= 0.3:
        return "Sec"
    if sentiments[-1] == "Courtois" and count.get("Courtois", 0) / total >= 0.5:
        return "Courtois"
    if sentiments[-1] == "Neutre" and "Sec" not in count:
        return "Neutre"
    return max(AGENT_CANDIDATES, key=lambda x: count.get(x, 0))


def call_id_from_chunk_filename(filename: str, chunk_idx: Optional[int]) -> str:
    """Normalize a chunk's file name to its call id
    (sentiment_analysis.py:188-197): strip extension, then a trailing
    ``_{chunk_idx}`` suffix when present."""
    base = filename.rsplit(".", 1)[0]
    if isinstance(chunk_idx, int):
        suffix = f"_{chunk_idx}"
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    return base
