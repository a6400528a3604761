"""Minimal PDB coordinate reader (ATOM/HETATM records).

The reference's Model-fitting tab takes "a set of pdb coordinates" to
evaluate fit after each refinement iteration (pyp_config.toml [tabs.model]).
Only what model-map scoring needs is parsed: positions, element symbols,
occupancies and B-factors. Fixed-column parsing per the PDB v3 spec."""

from __future__ import annotations

import numpy as np

# element -> approximate electron count (scattering weight for a
# low-resolution Gaussian-atom model)
ELECTRONS = {"H": 1, "C": 6, "N": 7, "O": 8, "P": 15, "S": 16,
             "FE": 26, "ZN": 30, "MG": 12, "CA": 20, "MN": 25, "K": 19,
             "NA": 11, "CL": 17}


def read_pdb(path):
    """-> dict with coords (N, 3) Å (x, y, z), weights (N,) electrons,
    bfactors (N,), elements list."""
    coords, weights, bfacs, elems = [], [], [], []
    with open(path) as f:
        for line in f:
            if not (line.startswith("ATOM") or line.startswith("HETATM")):
                continue
            x = float(line[30:38])
            y = float(line[38:46])
            z = float(line[46:54])
            occ = float(line[54:60] or 1.0) if line[54:60].strip() else 1.0
            bf = float(line[60:66]) if line[60:66].strip() else 0.0
            el = line[76:78].strip().upper()
            if not el:  # fall back to the atom-name column
                el = line[12:16].strip().lstrip("0123456789")[:1].upper()
            coords.append((x, y, z))
            weights.append(occ * ELECTRONS.get(el, 6))
            bfacs.append(bf)
            elems.append(el)
    if not coords:
        raise ValueError(f"no ATOM/HETATM records in {path}")
    return {
        "coords": np.asarray(coords, dtype=np.float32),
        "weights": np.asarray(weights, dtype=np.float32),
        "bfactors": np.asarray(bfacs, dtype=np.float32),
        "elements": elems,
    }


def write_pdb(coords, path, elements=None, bfactors=None):
    """Write bare ATOM records (test fixtures / exporting fitted models)."""
    coords = np.asarray(coords, dtype=np.float32)
    elements = elements or ["C"] * len(coords)
    bfactors = (np.zeros(len(coords), np.float32)
                if bfactors is None else np.asarray(bfactors))
    with open(path, "w") as f:
        for i, ((x, y, z), el, bf) in enumerate(
                zip(coords, elements, bfactors), start=1):
            # exact v3 columns: record(1-6) serial(7-11) name(13-16)
            # altLoc(17) resName(18-20) chain(22) resSeq(23-26) iCode(27)
            # x(31-38) y z occ(55-60) b(61-66) element(77-78)
            line = (f"ATOM  {i:5d} {el:<4s} ALA A{1:4d} "
                    f"   {x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{bf:6.2f}"
                    f"          {el:>2s}")
            assert len(line) == 78 and line[30:38] == f"{x:8.3f}", line
            f.write(line + "\n")
        f.write("END\n")
    return str(path)
