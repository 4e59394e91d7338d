"""Fold manifest reading, copied from the JAX package's data/manifest.py
(reference: feed xlsx files, train_model.py:107-110).

Schema: columns ``p-id, image_path, label_path, zones_path`` — one row per
case (reference feed: tf2.5/feed/prostateX_200_*-fold-*.xlsx). Supports:

  * .csv / .tsv (preferred going forward),
  * .xlsx via a minimal self-contained reader (zip + XML — no openpyxl
    dependency in the image), so the reference's shipped fold files load
    as-is.
"""

from __future__ import annotations

import csv
import os
import re
import zipfile
from typing import Dict, List
from xml.etree import ElementTree

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def _col_index(cell_ref: str) -> int:
    letters = re.match(r"[A-Z]+", cell_ref).group(0)
    idx = 0
    for ch in letters:
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def read_xlsx(path: str) -> List[Dict[str, str]]:
    """Read the first worksheet of an xlsx into a list of row dicts."""
    with zipfile.ZipFile(path) as z:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ElementTree.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall(f"{_NS}si"):
                shared.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
        sheet_names = sorted(
            n for n in z.namelist() if re.match(r"xl/worksheets/sheet\d+\.xml", n))
        root = ElementTree.fromstring(z.read(sheet_names[0]))
        rows: List[List[str]] = []
        for row in root.iter(f"{_NS}row"):
            cells: Dict[int, str] = {}
            for c in row.findall(f"{_NS}c"):
                ref = c.get("r", "A1")
                t = c.get("t")
                v = c.find(f"{_NS}v")
                if t == "inlineStr":
                    text = "".join(
                        el.text or "" for el in c.iter(f"{_NS}t"))
                elif v is None:
                    text = ""
                elif t == "s":
                    text = shared[int(v.text)]
                else:
                    text = v.text or ""
                cells[_col_index(ref)] = text
            width = max(cells) + 1 if cells else 0
            rows.append([cells.get(i, "") for i in range(width)])
    if not rows:
        return []
    header = rows[0]
    return [
        {header[i]: (r[i] if i < len(r) else "") for i in range(len(header))}
        for r in rows[1:]
        if any(x != "" for x in r)
    ]


def read_manifest(path: str) -> List[Dict[str, str]]:
    """Read a fold manifest (.xlsx/.csv/.tsv) into row dicts."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".xlsx":
        return read_xlsx(path)
    delim = "\t" if ext == ".tsv" else ","
    with open(path, newline="") as f:
        return [dict(r) for r in csv.DictReader(f, delimiter=delim)]
