"""Minimal first-party .xlsx reader (no openpyxl/pandas dependency).

Reads the business glossaries the reference loads with
pandas.read_excel (services/topics_inf.py:77, speech_segment.py:34-64):
shared strings, inline strings, numbers, and multiple sheets. Returns
rows as lists of Python values (str/float/None).
"""

from __future__ import annotations

import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional
from xml.etree import ElementTree as ET

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
       "r": "http://schemas.openxmlformats.org/officeDocument/2006/relationships"}


def _col_index(cell_ref: str) -> int:
    """'B7' -> 1 (zero-based column)."""
    col = 0
    for ch in cell_ref:
        if ch.isalpha():
            col = col * 26 + (ord(ch.upper()) - ord("A") + 1)
        else:
            break
    return col - 1


def _cell_value(cell, shared: List[str]) -> Any:
    t = cell.get("t", "n")
    v = cell.find("m:v", _NS)
    if t == "s":  # shared string
        return shared[int(v.text)] if v is not None else None
    if t == "inlineStr":
        is_el = cell.find("m:is", _NS)
        if is_el is not None:
            return "".join(tn.text or "" for tn in is_el.iter(
                "{%s}t" % _NS["m"]))
        return None
    if t == "str":  # formula string result
        return v.text if v is not None else None
    if t == "b":
        return bool(int(v.text)) if v is not None else None
    if v is None or v.text is None:
        return None
    try:
        f = float(v.text)
        return f
    except ValueError:
        return v.text


def sheet_names(path: str | Path) -> List[str]:
    with zipfile.ZipFile(path) as z:
        wb = ET.fromstring(z.read("xl/workbook.xml"))
        return [s.get("name") for s in wb.iter("{%s}sheet" % _NS["m"])]


def read_sheet(path: str | Path,
               sheet_name: Optional[str] = None) -> List[List[Any]]:
    """Rows of the named (or first) sheet, ragged rows padded later by
    callers as needed."""
    with zipfile.ZipFile(path) as z:
        # sheet name -> sheet file via workbook + rels
        wb = ET.fromstring(z.read("xl/workbook.xml"))
        sheets = list(wb.iter("{%s}sheet" % _NS["m"]))
        if not sheets:
            raise ValueError("workbook has no sheets")
        target = None
        for s in sheets:
            if sheet_name is None or s.get("name") == sheet_name:
                target = s
                break
        if target is None:
            raise KeyError(f"sheet {sheet_name!r} not found in {path}")
        rid = target.get("{%s}id" % _NS["r"])
        rels = ET.fromstring(z.read("xl/_rels/workbook.xml.rels"))
        sheet_path = None
        for rel in rels:
            if rel.get("Id") == rid:
                sheet_path = "xl/" + rel.get("Target").lstrip("/")
                sheet_path = sheet_path.replace("xl/xl/", "xl/")
        if sheet_path is None:  # fallback by position
            idx = sheets.index(target) + 1
            sheet_path = f"xl/worksheets/sheet{idx}.xml"

        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            ss = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in ss.iter("{%s}si" % _NS["m"]):
                shared.append("".join(tn.text or "" for tn in si.iter(
                    "{%s}t" % _NS["m"])))

        sheet = ET.fromstring(z.read(sheet_path))
        rows: List[List[Any]] = []
        for row in sheet.iter("{%s}row" % _NS["m"]):
            values: List[Any] = []
            for cell in row.iter("{%s}c" % _NS["m"]):
                ref = cell.get("r", "")
                col = _col_index(ref) if ref else len(values)
                while len(values) < col:
                    values.append(None)
                values.append(_cell_value(cell, shared))
            rows.append(values)
        return rows


def read_table(path: str | Path, sheet_name: Optional[str] = None
               ) -> Dict[str, List[Any]]:
    """First row = headers; returns {header: column values}."""
    rows = read_sheet(path, sheet_name)
    if not rows:
        return {}
    headers = [str(h) if h is not None else f"col{i}"
               for i, h in enumerate(rows[0])]
    n = len(headers)
    table: Dict[str, List[Any]] = {h: [] for h in headers}
    for row in rows[1:]:
        padded = list(row) + [None] * (n - len(row))
        for h, v in zip(headers, padded):
            table[h].append(v)
    return table
