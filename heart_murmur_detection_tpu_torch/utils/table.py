"""Metadata tables without pandas: the JAX package's respiratory processors
read their CSV / TSV / XLSX metadata with pandas (`read_csv`, `read_excel`,
`.set_index(...).loc[...]`, `iterrows`, `merge`), and the machine with the
card has no pandas. This module reads the same files into plain Python
values the way pandas 2.x / 3.x types them, so a processor here writes the
arrays the JAX one writes:

- each column is typed as pandas' C parser types it: all integers -> int
  (float when a cell is missing), all numbers -> float, all
  True/False spellings -> bool (an object column of bools and NaN when a
  cell is missing), all missing -> float NaN, otherwise str with float
  NaN for the missing cells; `as_str=True` is `dtype=str` (str, NaN for the
  missing cells). A cell is missing when it is empty or one of pandas'
  default NA strings; blank lines are skipped;
- `iterrows` upcasts a row of int and float columns to float, as pandas
  does, and keeps each value's type otherwise;
- `Lookup.loc` is `Series.loc`: the value of a unique key, an array of the
  values of a repeated key, KeyError for a missing one.

tests/test_torch_legacy.py pins these rules to pandas.
"""

from __future__ import annotations

import csv
import math
import re
import zipfile
from typing import Dict, Iterator, List, Optional, Sequence, Tuple
from xml.etree import ElementTree

import numpy as np

NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])
TRUE_STRINGS = frozenset(["True", "TRUE", "true"])
FALSE_STRINGS = frozenset(["False", "FALSE", "false"])
NAN = float("nan")

_INT = re.compile(r"^\s*[+-]?\d+\s*$")
_FLOAT = re.compile(
    r"^\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\s*$", re.I)


def is_na(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _kind(raw: Sequence[Optional[str]]) -> str:
    """The pandas type of a column of cell strings (None = missing)."""
    vals = [v for v in raw if v is not None]
    if not vals:
        return "float"
    if all(_INT.match(v) for v in vals):
        return "int" if len(vals) == len(raw) else "float"
    if all(_FLOAT.match(v) for v in vals):
        return "float"
    if all(v in TRUE_STRINGS or v in FALSE_STRINGS for v in vals):
        return "bool" if len(vals) == len(raw) else "object"
    return "str"


def _convert(raw: Sequence[Optional[str]], kind: str) -> list:
    if kind == "int":
        return [int(v) for v in raw]
    if kind == "float":
        return [NAN if v is None else float(v) for v in raw]
    if kind in ("bool", "object"):
        return [NAN if v is None else v in TRUE_STRINGS for v in raw]
    return [NAN if v is None else v for v in raw]


class Frame:
    """Columns of typed values, in file order (pandas' DataFrame, read-only)."""

    def __init__(self, columns: Dict[str, list], kinds: Dict[str, str]):
        self.columns = columns
        self.kinds = kinds

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __getitem__(self, name: str) -> list:
        return self.columns[name]

    def iterrows(self, index_col: Optional[str] = None) -> Iterator[Tuple[object, dict]]:
        """(index value or row number, {column: value}) per row; a row of
        int and float columns only is upcast to float, as pandas' iterrows."""
        names = [c for c in self.columns if c != index_col]
        kinds = {self.kinds[c] for c in names}
        upcast = kinds <= {"int", "float"} and "float" in kinds
        for i in range(len(self)):
            row = {c: self.columns[c][i] for c in names}
            if upcast:
                row = {c: float(v) for c, v in row.items()}
            yield (self.columns[index_col][i] if index_col else i), row

    def take(self, rows: Sequence[int]) -> "Frame":
        return Frame({c: [v[i] for i in rows] for c, v in self.columns.items()}, self.kinds)

    def where(self, mask: Sequence[bool]) -> "Frame":
        return self.take([i for i, m in enumerate(mask) if m])

    def str_contains(self, name: str, pattern: str) -> List[bool]:
        """Series.str.contains(pattern) for a literal pattern: NaN cells are
        False (pandas' str dtype); a column pandas does not type as str
        raises AttributeError, as the .str accessor does."""
        if self.kinds[name] != "str":
            raise AttributeError(f"Can only use .str accessor with string values ({name!r})")
        return [isinstance(v, str) and pattern in v for v in self.columns[name]]

    def lookup(self, key: str, value: str) -> "Lookup":
        """df.set_index(key)[value]."""
        return Lookup(self.columns[key], self.columns[value])


class Lookup:
    def __init__(self, keys: Sequence, values: Sequence):
        self._rows: Dict[object, list] = {}
        for k, v in zip(keys, values):
            self._rows.setdefault(k, []).append(v)

    def loc(self, key):
        """Series.loc[key]: the value, an array of the values of a repeated
        key, KeyError for a missing key."""
        vals = self._rows[key]
        if len(vals) == 1:
            return vals[0]
        return np.array(vals, dtype=object) if any(is_na(v) for v in vals) else np.array(vals)


def _raw_rows(path: str, sep: str) -> List[List[str]]:
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = list(csv.reader(f, delimiter=sep))
    blank = " \t".replace(sep, "")
    return [r for r in rows if r and not (len(r) == 1 and r[0].strip(blank) == "")]


def read_csv(path: str, sep: str = ",", names: Optional[Sequence[str]] = None,
             as_str: bool = False) -> Frame:
    """pandas.read_csv(path, sep=sep, names=names[, dtype=str]) as a Frame:
    the first row is the header unless `names` are given; a short row's
    missing cells are NA; a row longer than the header raises."""
    rows = _raw_rows(path, sep)
    if names is None:
        header, rows = rows[0], rows[1:]
    else:
        header = list(names)
    raw: Dict[str, List[Optional[str]]] = {c: [] for c in header}
    for n, r in enumerate(rows):
        if len(r) > len(header):
            raise ValueError(f"{path}: row {n} has {len(r)} fields, the header {len(header)}")
        r = r + [""] * (len(header) - len(r))
        for c, v in zip(header, r):
            raw[c].append(None if v in NA_STRINGS else v)
    kinds = {c: ("str" if as_str else _kind(v)) for c, v in raw.items()}
    return Frame({c: _convert(v, kinds[c]) for c, v in raw.items()}, kinds)


def merge_inner(left: Frame, right: Frame, on: str) -> Frame:
    """pandas.merge(left, right, on=on) (how="inner"): the left rows in
    order, each joined with its matching right rows in order."""
    by_key: Dict[object, List[int]] = {}
    for j, k in enumerate(right[on]):
        by_key.setdefault(k, []).append(j)
    li, ri = [], []
    for i, k in enumerate(left[on]):
        for j in by_key.get(k, ()):
            li.append(i)
            ri.append(j)
    cols = {c: [v[i] for i in li] for c, v in left.columns.items()}
    cols.update({c: [v[j] for j in ri] for c, v in right.columns.items() if c != on})
    kinds = dict(left.kinds)
    kinds.update({c: k for c, k in right.kinds.items() if c != on})
    return Frame(cols, kinds)


# ---------------------------------------------------------------------------
# XLSX (pandas.read_excel through openpyxl): the first sheet, row 1 the header
# ---------------------------------------------------------------------------

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
       "r": "http://schemas.openxmlformats.org/officeDocument/2006/relationships",
       "p": "http://schemas.openxmlformats.org/package/2006/relationships"}


def _col_index(ref: str) -> int:
    n = 0
    for ch in re.match(r"[A-Z]+", ref).group(0):
        n = n * 26 + ord(ch) - 64
    return n - 1


def _first_sheet_path(z: zipfile.ZipFile) -> str:
    wb = ElementTree.fromstring(z.read("xl/workbook.xml"))
    rid = wb.find("m:sheets/m:sheet", _NS).get(f"{{{_NS['r']}}}id")
    rels = ElementTree.fromstring(z.read("xl/_rels/workbook.xml.rels"))
    for rel in rels.findall("p:Relationship", _NS):
        if rel.get("Id") == rid:
            target = rel.get("Target")
            return target.lstrip("/") if target.startswith("/") else "xl/" + target
    raise KeyError(f"sheet relationship {rid}")


def _cell_value(c, shared: List[str]):
    """openpyxl's cell value: shared / inline strings, booleans, numbers as
    int when written without '.' or an exponent (openpyxl's _cast_number)."""
    t = c.get("t", "n")
    if t == "inlineStr":
        return "".join(x.text or "" for x in c.iter(f"{{{_NS['m']}}}t"))
    v = c.find("m:v", _NS)
    if v is None or v.text is None:
        return None
    if t == "s":
        return shared[int(v.text)]
    if t in ("str", "e"):
        return v.text
    if t == "b":
        return v.text == "1"
    text = v.text
    return float(text) if ("." in text or "e" in text or "E" in text) else int(text)


def _excel_kind(vals: list) -> str:
    present = [v for v in vals if v is not None]
    if not present:
        return "float"
    if all(isinstance(v, bool) for v in present):
        return "bool" if len(present) == len(vals) else "object"
    if all(isinstance(v, int) and not isinstance(v, bool) for v in present):
        return "int" if len(present) == len(vals) else "float"
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present):
        return "float"
    return "str" if all(isinstance(v, str) for v in present) else "object"


def read_excel(path: str) -> Frame:
    """pandas.read_excel(path) of an .xlsx: the first sheet, its first row
    the header, trailing empty rows dropped, columns typed as pandas types
    openpyxl's values."""
    with zipfile.ZipFile(path) as z:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            sst = ElementTree.fromstring(z.read("xl/sharedStrings.xml"))
            for si in sst.findall("m:si", _NS):
                shared.append("".join(x.text or "" for x in si.iter(f"{{{_NS['m']}}}t")))
        sheet = ElementTree.fromstring(z.read(_first_sheet_path(z)))
    grid: Dict[int, Dict[int, object]] = {}
    for row in sheet.iter(f"{{{_NS['m']}}}row"):
        r = int(row.get("r")) - 1
        for c in row.findall("m:c", _NS):
            val = _cell_value(c, shared)
            if val is not None:
                grid.setdefault(r, {})[_col_index(c.get("r"))] = val
    n_rows = max(grid) + 1 if grid else 0
    n_cols = max((max(r) + 1 for r in grid.values()), default=0)
    header = [grid.get(0, {}).get(j) for j in range(n_cols)]
    cols: Dict[str, list] = {}
    kinds: Dict[str, str] = {}
    for j, name in enumerate(header):
        vals = [grid.get(i, {}).get(j) for i in range(1, n_rows)]
        kind = _excel_kind(vals)
        cols[name] = [NAN if v is None else (float(v) if kind == "float" else v) for v in vals]
        kinds[name] = kind
    return Frame(cols, kinds)
