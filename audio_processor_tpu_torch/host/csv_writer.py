"""CSV results writer (reference 17-column schema,
services/pipeline.py:603-662)."""

from __future__ import annotations

import csv
from datetime import datetime
from pathlib import Path
from typing import Dict, List

COLUMNS = [
    "file_name", "agent_transcription", "client_transcription",
    "transcription_chunk", "error",
    "agent_text_sentiment", "agent_text_confidence",
    "agent_acoustic_sentiment", "agent_acoustic_confidence",
    "agent_fusion_sentiment", "agent_fusion_confidence",
    "client_text_sentiment", "client_text_confidence",
    "client_acoustic_sentiment", "client_acoustic_confidence",
    "client_fusion_sentiment", "client_fusion_confidence",
]


def _row(result: Dict) -> Dict:
    failed = bool(result.get("error")) and \
        not result.get("transcription_chunk")
    row = {c: "" for c in COLUMNS}
    row["file_name"] = result.get("file_name", "")
    row["error"] = result.get("error", "")
    for c in COLUMNS:
        if c.endswith("_confidence"):
            row[c] = 0.0
    if failed:
        return row
    for c in COLUMNS[1:]:
        if c == "error":
            continue
        default = 0.0 if c.endswith("_confidence") else ""
        row[c] = result.get(c, default)
    return row


def save_results_csv(results: List[Dict], output_dir: str | Path,
                     timestamp: str | None = None) -> Path:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    ts = timestamp or datetime.now().strftime("%Y%m%d_%H%M%S")
    out = output_dir / f"optimized_results_{ts}.csv"
    with open(out, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=COLUMNS)
        w.writeheader()
        for r in results:
            w.writerow(_row(r))
    return out
