"""FREALIGN .par/.parx text parameter files.

Formats (reverse-spec'd from pyp/inout/metadata/
frealign_parfile.py:90-137): fixed-width tables with 'C'-prefixed comment
headers. Supported variants:

  new        16 cols: NO PSI THETA PHI SHX SHY MAG FILM DF1 DF2 ANGAST OCC
                      LOGP SIGMA SCORE CHANGE
  frealignx  17 cols: + PSHIFT after ANGAST
  cclin      13 cols: NUM PSI THETA PHI SX SY MAG FILM DF1 DF2 ANGAST PRESA DPRESA
  extended   45/46 cols: + PTLIND TILTAN DOSEXX SCANOR CNFDNC PTLCCX AXIS
                      NORM0-2 MATRIX00-15 PPSI PTHETA PPHI (tomo .parx)
"""

from __future__ import annotations

import numpy as np

NEW_COLUMNS = [
    "NO", "PSI", "THETA", "PHI", "SHX", "SHY", "MAG", "FILM",
    "DF1", "DF2", "ANGAST", "OCC", "LOGP", "SIGMA", "SCORE", "CHANGE",
]
FREALIGNX_COLUMNS = [
    "NO", "PSI", "THETA", "PHI", "SHX", "SHY", "MAG", "FILM",
    "DF1", "DF2", "ANGAST", "PSHIFT", "OCC", "LOGP", "SIGMA", "SCORE", "CHANGE",
]
CCLIN_COLUMNS = [
    "NUM", "PSI", "THETA", "PHI", "SX", "SY", "MAG", "FILM",
    "DF1", "DF2", "ANGAST", "PRESA", "DPRESA",
]
EXTENDED_TAIL = [
    "PTLIND", "TILTAN", "DOSEXX", "SCANOR", "CNFDNC", "PTLCCX", "AXIS",
    "NORM0", "NORM1", "NORM2",
] + [f"MATRIX{i:02d}" for i in range(16)] + ["PPSI", "PTHETA", "PPHI"]

# fixed-width printf formats matching the reference templates exactly
_FMT_NEW = "%7d%8.2f%8.2f%8.2f%10.2f%10.2f%8.0f%6d%9.1f%9.1f%8.2f%8.2f%10d%11.4f%8.2f%8.2f"
_FMT_FREALIGNX = "%7d%8.2f%8.2f%8.2f%10.2f%10.2f%8.0f%6d%9.1f%9.1f%8.2f%8.2f%8.2f%10d%11.4f%8.2f%8.2f"
_FMT_CCLIN = "%7d%8.2f%8.2f%8.2f%10.2f%10.2f%8.0f%6d%9.1f%9.1f%8.2f%8.2f%8.2f"
_FMT_EXT_TAIL = (
    "%9d%9.2f%9.2f%9d%9.2f%9.2f%10.4f"
    + "%10.4f" * 3
    + "%10.4f" * 16
    + "%10.4f%10.4f%10.4f"
)

VARIANTS = {
    "new": (NEW_COLUMNS, _FMT_NEW),
    "frealignx": (FREALIGNX_COLUMNS, _FMT_FREALIGNX),
    "cclin": (CCLIN_COLUMNS, _FMT_CCLIN),
}


def _header_lines(columns, title):
    nums = "".join(f"{i + 1:>8d}" for i in range(len(columns)))
    names = "".join(f"{c:>8s}" for c in columns)
    return [f"C {title} parameter file", "C " + nums.lstrip()[:230], "C " + names.lstrip()[:2300]]


class ParFile:
    """In-memory .par table: dict of column -> float64 array, ordered."""

    def __init__(self, columns, data=None):
        self.columns = list(columns)
        n = 0 if data is None else len(next(iter(data.values())))
        self.data = {c: (np.zeros(n) if data is None or c not in data else np.asarray(data[c], dtype=np.float64)) for c in self.columns}

    @property
    def n_rows(self):
        return len(self.data[self.columns[0]]) if self.columns else 0

    def __getitem__(self, c):
        return self.data[c]

    def __setitem__(self, c, v):
        if c not in self.columns:
            self.columns.append(c)
        self.data[c] = np.asarray(v, dtype=np.float64)

    def as_array(self) -> np.ndarray:
        return np.stack([self.data[c] for c in self.columns], axis=1)

    @classmethod
    def zeros(cls, n, variant="new", extended=False):
        cols, _ = VARIANTS[variant]
        cols = list(cols) + (EXTENDED_TAIL if extended else [])
        pf = cls(cols)
        pf.data = {c: np.zeros(n) for c in cols}
        pf.data[cols[0]] = np.arange(1, n + 1, dtype=np.float64)
        if "MAG" in pf.data:
            pf.data["MAG"] = np.full(n, 10000.0)
        if "OCC" in pf.data:
            pf.data["OCC"] = np.full(n, 100.0)
        return pf


def _detect_variant(ncols):
    if ncols == 16:
        return "new", False
    if ncols == 17:
        return "frealignx", False
    if ncols == 13:
        return "cclin", False
    if ncols == 45:
        return "new", True
    if ncols == 46:
        return "frealignx", True
    raise ValueError(f"unrecognized .par column count {ncols}")


def read(path) -> ParFile:
    rows = []
    if str(path).endswith(".bz2"):
        import bz2

        opener = lambda p: bz2.open(p, "rt")  # noqa: E731
    else:
        opener = open
    with opener(path) as f:
        for line in f:
            if line.startswith("C") or not line.strip():
                continue
            rows.append([float(tok) for tok in line.split()])
    if not rows:
        return ParFile(NEW_COLUMNS)
    arr = np.asarray(rows, dtype=np.float64)
    variant, extended = _detect_variant(arr.shape[1])
    cols = list(VARIANTS[variant][0]) + (EXTENDED_TAIL if extended else [])
    return ParFile(cols, {c: arr[:, i] for i, c in enumerate(cols)})


def write(pf: ParFile, path, variant=None):
    cols = pf.columns
    if variant is None:
        base_n = len(cols) if len(cols) <= 17 else len(cols) - len(EXTENDED_TAIL)
        variant = {16: "new", 17: "frealignx", 13: "cclin"}[base_n]
    base_cols, fmt = VARIANTS[variant]
    extended = len(cols) > len(base_cols)
    fmt_full = fmt + (_FMT_EXT_TAIL if extended else "")
    title = {"new": "FREALIGN NEW", "frealignx": "FREALIGNX", "cclin": "FREALIGN CCLIN"}[variant]
    if extended:
        title = title.replace("FREALIGN ", "FREALIGN EXTENDED ").replace("FREALIGNX", "FREALIGN EXTENDED FREALIGNX")
    specs = fmt_full.replace("%", " %").split()
    int_cols = {i for i, s in enumerate(specs) if s.endswith("d")}
    # transparent bz2 (reference refine_parfile_compress: .par.bz2 files
    # move between swarm and merge compressed)
    if str(path).endswith(".bz2"):
        import bz2

        opener = lambda p: bz2.open(p, "wt")  # noqa: E731
    else:
        opener = lambda p: open(p, "w")  # noqa: E731
    with opener(path) as f:
        for line in _header_lines(cols, title):
            f.write(line + "\n")
        arr = pf.as_array()
        for row in arr:
            parts = []
            for i, s in enumerate(specs):
                v = int(round(row[i])) if i in int_cols else row[i]
                parts.append(s % v)
            f.write("".join(parts) + "\n")


def to_cistem_table(pf: ParFile):
    """FREALIGN .par -> .cistem table with SEMANTIC conversion.

    FREALIGN SHX/SHY (Å) carry the opposite sign of the internal pose
    convention (the centering translation, = RELION origin semantics): the
    reference's own par->star conversion negates them
    (pyp_metadata.py:1114 `shifts = -(refinement[["X_SHIFT", "Y_SHIFT"]])`).
    """
    from pyp_tpu_torch.io import cistem

    n = pf.n_rows
    # cclin spells NO/SHX/SHY as NUM/SX/SY
    col = {c: c for c in pf.columns}
    col.setdefault("NO", "NUM" if "NUM" in pf.columns else "NO")
    col.setdefault("SHX", "SX" if "SX" in pf.columns else "SHX")
    col.setdefault("SHY", "SY" if "SY" in pf.columns else "SHY")
    table = cistem.Table.zeros(n)
    table["position_in_stack"] = pf[col["NO"]]
    table["phi"] = pf["PHI"]
    table["theta"] = pf["THETA"]
    table["psi"] = pf["PSI"]
    table["x_shift"] = -np.asarray(pf[col["SHX"]], dtype=np.float64)
    table["y_shift"] = -np.asarray(pf[col["SHY"]], dtype=np.float64)
    table["defocus_1"] = pf["DF1"]
    table["defocus_2"] = pf["DF2"]
    table["defocus_angle"] = pf["ANGAST"]
    if "OCC" in pf.columns:
        table["occupancy"] = pf["OCC"]
    if "SCORE" in pf.columns:
        table["score"] = pf["SCORE"]
    return table


def from_cistem_table(table, variant: str = "new", mag: float = 10000.0):
    """.cistem table -> FREALIGN .par with the same semantic sign flip as
    `to_cistem_table` (SHX = -x_shift)."""
    n = table.n_rows
    pf = ParFile.zeros(n, variant=variant)
    cclin = variant == "cclin"
    no_c, shx_c, shy_c = (("NUM", "SX", "SY") if cclin
                          else ("NO", "SHX", "SHY"))
    pf[no_c] = np.asarray(table["position_in_stack"])
    pf["PHI"] = np.asarray(table["phi"])
    pf["THETA"] = np.asarray(table["theta"])
    pf["PSI"] = np.asarray(table["psi"])
    pf[shx_c] = -np.asarray(table["x_shift"])
    pf[shy_c] = -np.asarray(table["y_shift"])
    pf["DF1"] = np.asarray(table["defocus_1"])
    pf["DF2"] = np.asarray(table["defocus_2"])
    pf["ANGAST"] = np.asarray(table["defocus_angle"])
    pf["MAG"] = np.full(n, mag)
    if "occupancy" in table and "OCC" in pf.columns:
        pf["OCC"] = np.asarray(table["occupancy"])
    if "score" in table and "SCORE" in pf.columns:
        pf["SCORE"] = np.asarray(table["score"])
    return pf
