"""RELION 4/5 tomogram + particle star interop.

The reference exports tomo projects to RELION as two star files
(`GlobalMetadata.meta2Star` tomo branch, pyp_metadata.py:1148-1500) and
imports RELION5 refinements back (`TomoStar2metaV5`, pyp_metadata.py:2329):

  * tomograms.star — `data_global` with one row per tilt-series
    (rlnTomoName/TiltSeriesName/FrameCount/SizeX/Y/Z/Hand/OpticsGroupName/
    TiltSeriesPixelSize/Voltage/Cs/Ac/FractionalDose) plus one
    `data_<name>` block per series whose rows carry the 4x4 projection
    matrix as `[x,y,z,w]` column quadruples (_rlnTomoProjX/Y/Z/W) followed
    by DefocusU/V/Angle, CtfScalefactor, MicrographPreExposure;
  * particles star (RELION5 2D-stack flavor) — `data_general` with
    _rlnTomoSubTomosAre2DStacks, `data_optics`, and `data_particles` with
    per-particle tomogram coords (px), origins (Å), ZYZ Euler angles
    (rot/tilt/psi), and bookkeeping columns.

Projection matrices come from
`core.geometry.relion_tomo_projection_matrix`, pinned to the reference's
`getRelionMatrix` by golden fixtures (tests/golden/ref_relion_tomo_*).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from pyp_tpu_torch.core.geometry import relion_tomo_projection_matrix

_GLOBAL_COLS = (
    "_rlnTomoName", "_rlnTomoTiltSeriesName", "_rlnTomoFrameCount",
    "_rlnTomoSizeX", "_rlnTomoSizeY", "_rlnTomoSizeZ", "_rlnTomoHand",
    "_rlnOpticsGroupName", "_rlnTomoTiltSeriesPixelSize", "_rlnVoltage",
    "_rlnSphericalAberration", "_rlnAmplitudeContrast",
    "_rlnTomoImportFractionalDose",
)
_TILT_COLS = (
    "_rlnTomoProjX", "_rlnTomoProjY", "_rlnTomoProjZ", "_rlnTomoProjW",
    "_rlnDefocusU", "_rlnDefocusV", "_rlnDefocusAngle",
    "_rlnCtfScalefactor", "_rlnMicrographPreExposure",
)
_OPTICS_COLS = (
    "_rlnOpticsGroup", "_rlnOpticsGroupName", "_rlnSphericalAberration",
    "_rlnVoltage", "_rlnTomoTiltSeriesPixelSize", "_rlnImageDimensionality",
    "_rlnTomoSubtomogramBinning", "_rlnImagePixelSize", "_rlnImageSize",
    "_rlnAmplitudeContrast",
)
_PARTICLE_COLS = (
    "_rlnTomoName", "_rlnTomoParticleId", "_rlnCoordinateX",
    "_rlnCoordinateY", "_rlnCoordinateZ", "_rlnOriginXAngst",
    "_rlnOriginYAngst", "_rlnOriginZAngst", "_rlnAngleRot", "_rlnAngleTilt",
    "_rlnAnglePsi", "_rlnTomoParticleName", "_rlnOpticsGroup",
    "_rlnImageName", "_rlnTomoVisibleFrames",
)


def _loop_header(block: str, cols) -> str:
    lines = [f"data_{block}", "", "loop_"]
    lines += [f"{c} #{i + 1}" for i, c in enumerate(cols)]
    return "\n".join(lines) + "\n"


def export_tomograms_star(series: list[dict], params: dict, path):
    """Write tomograms.star for RELION ImportTomo.

    series: per tilt-series dicts with keys
      name, tilt_angles (T,), xf (T, 6) IMOD transforms, defocus (T, 2) Å,
      astig_angle (T,), order (T,) acquisition order,
      image_dims (x, y) raw pixels; optional exposure (T,) e-/Å².
    Geometry params: tomo_rec_thickness, tomo_rec_binning feed the unbinned
    tomogram frame the matrices live in."""
    pixel = float(params["scope_pixel"])
    dose = float(params.get("scope_dose_rate") or 1.0)
    thickness = float(params.get("tomo_rec_thickness") or 2048)
    hand = 1.0 if float(params.get("csp_ctf_handedness") or 1.0) else -1.0

    out = []
    head = _loop_header("global", _GLOBAL_COLS)
    body = []
    for i, s in enumerate(series):
        T = len(s["tilt_angles"])
        x, y = s["image_dims"]
        head += "\t".join(map(str, [
            s["name"], f"Movies/{s['name']}.mrc", T, x, y, int(thickness),
            hand, f"opticsGroup{i + 1}", pixel,
            float(params["scope_voltage"]), float(params["scope_cs"]),
            float(params["scope_wgh"]), dose,
        ])) + "\n"
        rows = [_loop_header(s["name"], _TILT_COLS)]
        exposure = s.get("exposure")
        for t in range(T):
            m = relion_tomo_projection_matrix(
                float(s["tilt_angles"][t]), np.asarray(s["xf"][t], float),
                thickness, (x, y), x, y)
            m = np.asarray(m, dtype=np.float64)
            m[:-1, 3] = 0.0  # the reference zeroes translations on export
            cells = " ".join(
                "[" + ",".join(f"{m[r, c]:.8f}" for c in range(4)) + "]"
                for r in range(4))
            exp = (float(exposure[t]) if exposure is not None
                   else float(s["order"][t]) * dose)
            rows.append(cells + " " + "\t".join(map(str, [
                float(s["defocus"][t][0]), float(s["defocus"][t][1]),
                float(s["astig_angle"][t]), 1.0, exp])) + "\n")
        body.append("".join(rows))
    out.append(head)
    out.extend("\n" + b for b in body)
    Path(path).write_text("\n".join(out))
    return path


def export_particles_star_v5(particles: dict, params: dict, path):
    """RELION5 2D-stack particles star (ImportParticles).

    particles: dict with tomo_names (P,), positions (P, 3) (x, y, z)
    unbinned px, eulers (P, 3) PYP ZYZ (phi, theta, psi) -> RELION
    (rot, tilt, psi), shifts (P, 3) Å origins; optional visible (P, T)."""
    pixel = float(params["scope_pixel"])
    box = int(params.get("extract_box") or 0)
    ebin = int(params.get("extract_bin") or 1)
    lines = ["", "data_general", "", "_rlnTomoSubTomosAre2DStacks   1", ""]
    lines.append(_loop_header("optics", _OPTICS_COLS))
    lines.append("\t".join(map(str, [
        1, "opticsGroup1", float(params["scope_cs"]),
        float(params["scope_voltage"]), pixel, 2, ebin, pixel * ebin, box,
        float(params["scope_wgh"])])) + "\n")
    lines.append("")
    lines.append(_loop_header("particles", _PARTICLE_COLS))
    names = particles["tomo_names"]
    pos = np.asarray(particles["positions"], dtype=np.float64)
    eul = np.asarray(particles["eulers"], dtype=np.float64)
    sh = np.asarray(particles.get("shifts",
                                  np.zeros((len(names), 3))), dtype=float)
    visible = particles.get("visible")
    rows = []
    for p in range(len(names)):
        vis = ("[" + ",".join(
            str(int(v)) for v in np.asarray(visible[p]).astype(int)) + "]"
            if visible is not None else "[1]")
        rows.append("\t".join(map(str, [
            names[p], p + 1,
            pos[p, 0], pos[p, 1], pos[p, 2],
            sh[p, 0], sh[p, 1], sh[p, 2],
            eul[p, 0], eul[p, 1], eul[p, 2],
            f"{names[p]}/{p + 1}", 1,
            f"{names[p]}_stack2d.mrcs", vis])))
    lines.append("\n".join(rows) + "\n")
    Path(path).write_text("\n".join(lines))
    return path


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------

def _parse_blocks(text: str) -> dict:
    """STAR blocks -> {name: (cols, rows)}; rows keep raw string cells so
    `[...]` matrix/flag cells survive."""
    blocks = {}
    cur, cols, rows, in_loop = None, [], [], False
    pending: list[tuple] = []

    def flush():
        if cur is not None:
            blocks[cur] = (list(cols), list(rows), dict(pending))

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("data_"):
            flush()
            cur, in_loop = line[5:], False
            cols, rows, pending = [], [], []
            continue
        if line == "loop_":
            in_loop = True
            continue
        if line.startswith("_rln"):
            label = line.split()[0]
            if in_loop:
                cols.append(label)
            else:  # key-value pair outside a loop (data_general)
                pending.append((label, line.split()[-1]))
            continue
        if cur is not None and cols:
            # split on whitespace but keep [..] groups (they contain commas,
            # and the reference separates matrix cells with spaces)
            cells = re.findall(r"\[[^\]]*\]|\S+", line)
            rows.append(cells)
    flush()
    return blocks


def import_tomograms_star(path) -> tuple[list[dict], dict]:
    """tomograms.star -> (series list, global params). Tilt angles are
    recovered from the projection matrices (the rotation block's
    [2,0] = -sin(tilt), [0,0] ~ cos(tilt) for identity xf)."""
    blocks = _parse_blocks(Path(path).read_text())
    cols, rows, _ = blocks["global"]
    ci = {c: i for i, c in enumerate(cols)}
    gparams = {}
    series = []
    for r in rows:
        name = r[ci["_rlnTomoName"]]
        gparams.setdefault("scope_pixel",
                           float(r[ci["_rlnTomoTiltSeriesPixelSize"]]))
        gparams.setdefault("scope_voltage", float(r[ci["_rlnVoltage"]]))
        gparams.setdefault("scope_cs",
                           float(r[ci["_rlnSphericalAberration"]]))
        gparams.setdefault("scope_wgh",
                           float(r[ci["_rlnAmplitudeContrast"]]))
        gparams.setdefault("scope_dose_rate",
                           float(r[ci["_rlnTomoImportFractionalDose"]]))
        gparams.setdefault("tomo_rec_thickness",
                           int(float(r[ci["_rlnTomoSizeZ"]])))
        tcols, trows, _ = blocks[name]
        ti = {c: i for i, c in enumerate(tcols)}
        mats, dfs, ast, exps = [], [], [], []
        for tr in trows:
            quads = [np.asarray([float(v) for v in q.strip("[]").split(",")])
                     for q in tr[:4]]
            mats.append(np.stack(quads, axis=0))  # group g = matrix row g
            rest = tr[4:]
            dfs.append((float(rest[ti["_rlnDefocusU"] - 4]),
                        float(rest[ti["_rlnDefocusV"] - 4])))
            ast.append(float(rest[ti["_rlnDefocusAngle"] - 4]))
            exps.append(float(rest[ti["_rlnMicrographPreExposure"] - 4]))
        mats = np.asarray(mats)
        # rotation rows 2 are untouched by the in-plane xf (it only mixes
        # rows 0/1): m[2,0] = -sin(tilt), m[2,2] = cos(tilt) exactly
        tilt = np.degrees(np.arctan2(-mats[:, 2, 0], mats[:, 2, 2]))
        series.append({
            "name": name,
            "n_tilts": int(float(r[ci["_rlnTomoFrameCount"]])),
            "image_dims": (int(float(r[ci["_rlnTomoSizeX"]])),
                           int(float(r[ci["_rlnTomoSizeY"]]))),
            "matrices": mats,
            "tilt_angles": tilt.astype(np.float32),
            "defocus": np.asarray(dfs, dtype=np.float32),
            "astig_angle": np.asarray(ast, dtype=np.float32),
            "exposure": np.asarray(exps, dtype=np.float32),
        })
    return series, gparams


def import_particles_star_v5(path) -> dict:
    """RELION5 particles star -> arrays (tomo_names, positions, eulers,
    shifts, visible) ready for pipeline/csp tables."""
    blocks = _parse_blocks(Path(path).read_text())
    cols, rows, _ = blocks["particles"]
    ci = {c: i for i, c in enumerate(cols)}
    names, pos, eul, sh, vis = [], [], [], [], []
    for r in rows:
        names.append(r[ci["_rlnTomoName"]])
        pos.append([float(r[ci["_rlnCoordinateX"]]),
                    float(r[ci["_rlnCoordinateY"]]),
                    float(r[ci["_rlnCoordinateZ"]])])
        eul.append([float(r[ci["_rlnAngleRot"]]),
                    float(r[ci["_rlnAngleTilt"]]),
                    float(r[ci["_rlnAnglePsi"]])])
        sh.append([float(r[ci["_rlnOriginXAngst"]]),
                   float(r[ci["_rlnOriginYAngst"]]),
                   float(r[ci["_rlnOriginZAngst"]])])
        if "_rlnTomoVisibleFrames" in ci:
            vis.append([int(v) for v in
                        r[ci["_rlnTomoVisibleFrames"]].strip("[]").split(",")])
    out = {
        "tomo_names": names,
        "positions": np.asarray(pos, dtype=np.float32),
        "eulers": np.asarray(eul, dtype=np.float32),
        "shifts": np.asarray(sh, dtype=np.float32),
    }
    if vis:
        out["visible"] = np.asarray(vis, dtype=np.int32)
    optics = blocks.get("optics")
    if optics:
        ocols, orows, _ = optics
        oi = {c: i for i, c in enumerate(ocols)}
        if orows:
            out["optics"] = {
                "pixel_size": float(orows[0][oi["_rlnTomoTiltSeriesPixelSize"]]),
                "voltage": float(orows[0][oi["_rlnVoltage"]]),
                "cs": float(orows[0][oi["_rlnSphericalAberration"]]),
                "box": int(float(orows[0][oi["_rlnImageSize"]])),
            }
    return out


# ---------------------------------------------------------------------------
# ArtiaX per-tilt-series star (ChimeraX mapped-back visualization)
# ---------------------------------------------------------------------------

_ARTIAX_COLS = (
    "_rlnTomoName", "_rlnCoordinateX", "_rlnCoordinateY", "_rlnCoordinateZ",
    "_rlnAngleRot", "_rlnAngleTilt", "_rlnAnglePsi",
    "_rlnOriginXAngst", "_rlnOriginYAngst", "_rlnOriginZAngst",
    "_rlnLogLikeliContribution", "_rlnClassNumber",
)


def export_artiax_star(name, positions, eulers, rec_shape, rec_binning,
                       path, scores=None, classes=None, shifts_angst=None):
    """Per-tilt-series particle star for ArtiaX/ChimeraX display.

    The reference writes these "ministar" files per series during the CSPT
    merge (generate_ministar, inout/metadata/core.py:3139; consumed per
    docs/guide/chimerax_artiax.rst: open the .rec, then the matching .star
    as an ArtiaX particle list). Coordinates land in the display
    tomogram's voxel frame (corner origin, z flipped to match the .rec
    orientation).

    positions: (P, 3) (z, y, x) CENTERED voxels in the CSP working frame
        (rec_binning working voxels per .rec voxel).
    eulers: (P, 3) (phi, theta, psi) degrees, PYP ZYZ (maps 1:1 to RELION
        rot/tilt/psi — io/relion.py convention note).
    rec_shape: (nz, ny, nx) of the display .rec volume.
    """
    pos = np.asarray(positions, dtype=np.float64)
    eul = np.asarray(eulers, dtype=np.float64)
    n = len(pos)
    nz, ny, nx = (int(v) for v in rec_shape)
    b = float(rec_binning)
    cx = pos[:, 2] / b + nx / 2.0
    cy = pos[:, 1] / b + ny / 2.0
    cz = nz - (pos[:, 0] / b + nz / 2.0)  # z flip (reference ministar)
    sc = (np.asarray(scores, dtype=np.float64) if scores is not None
          else np.zeros(n))
    cl = (np.asarray(classes, dtype=np.int64) if classes is not None
          else np.ones(n, dtype=np.int64))
    sh = (np.asarray(shifts_angst, dtype=np.float64)
          if shifts_angst is not None else np.zeros((n, 3)))
    lines = ["", "# version 30001", "", _loop_header("particles", _ARTIAX_COLS)]
    rows = []
    for p in range(n):
        rows.append("\t".join(map(str, [
            name, round(cx[p], 3), round(cy[p], 3), round(cz[p], 3),
            round(eul[p, 0], 3), round(eul[p, 1], 3), round(eul[p, 2], 3),
            round(sh[p, 0], 3), round(sh[p, 1], 3), round(sh[p, 2], 3),
            round(sc[p], 6), int(cl[p])])))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n".join(rows) + "\n")
    return path


def import_artiax_star(path):
    """Read back an ArtiaX ministar -> dict of column arrays."""
    txt = Path(path).read_text()
    cols, rows = [], []
    in_loop = False
    for line in txt.splitlines():
        s = line.strip()
        if s.startswith("_rln"):
            cols.append(s.split()[0])
            in_loop = True
            continue
        if in_loop and s and not s.startswith(("#", "data_", "loop_")):
            rows.append(s.split())
    out = {}
    for i, c in enumerate(cols):
        vals = [r[i] for r in rows]
        if c == "_rlnTomoName":
            out[c] = np.array(vals, dtype=object)
        else:
            out[c] = np.array([float(v) for v in vals])
    return out
