"""Text cleaning utilities.

Behavior-matched to the reference's transcript post-processing
(reference: utils/utils.py:74-79): strip a fixed set of punctuation —
including the Arabic question mark ``؟`` and Arabic comma ``،`` —
and lowercase the result.
"""

from __future__ import annotations

import re

# Same character class as the reference regex (utils/utils.py:78).
_CHARS_TO_REMOVE = re.compile(r"[\,\?\.\!\-\;:\"%\'\»\«\؟\(\)،\.]")


def remove_special_characters(text: str | None) -> str:
    if text is None:
        return ""
    return _CHARS_TO_REMOVE.sub("", text.lower())
