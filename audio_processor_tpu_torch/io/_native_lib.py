"""Shared lazy ctypes loader for optional system codec libraries.

Every optional-codec module (mp3/speex/gsm/opus) needs the same
dance: try a list of sonames plus ``ctypes.util.find_library``, bind
and sanity-check the symbols it needs, cache the result (including a
negative result) so availability probes are cheap. Centralised here
so the copies can't drift (the mp3 loader had already lost the
find_library fallback and the AttributeError guard the speex one
carried)."""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Callable, List, Optional


def load_first(sonames: List[str], find_name: Optional[str],
               configure: Callable[[ctypes.CDLL], None]
               ) -> Optional[ctypes.CDLL]:
    """Load the first library that both dlopens and passes
    ``configure`` (which should set restype/argtypes and will raise
    AttributeError on a stub/stripped build missing a symbol).

    ``find_name`` adds a ``ctypes.util.find_library`` candidate in
    front for hosts without the exact sonames in the search path
    (non-ldconfig layouts, macOS dylibs)."""
    names = list(sonames)
    if find_name:
        found = ctypes.util.find_library(find_name)
        if found and found not in names:
            names.insert(0, found)
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            configure(lib)
            return lib
        except (OSError, AttributeError):
            continue
    return None
