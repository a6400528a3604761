"""RELION interop: particles .star import/export to/from .cistem tables.

Equivalent of the reference's star conversions (inout/metadata/
pyp_metadata.py `GlobalMetadata.SpaStar2meta`/`TomoStar2meta` :763+,
cistem_star_file.to_star :779; bin/run/pyp import_star/export_star modes).

Angle convention: both RELION (rot, tilt, psi) and FREALIGN (phi, theta,
psi) parameterize the same ZYZ projection rotation, so they map 1:1
(rot=phi, tilt=theta, psi=psi). Origins: rlnOriginXAngst/YAngst carry the
same "shift to apply to the image to center the particle" meaning as our
pixel shifts (converted by pixel size).
"""

from __future__ import annotations

import numpy as np

from pyp_tpu_torch.io import cistem, star


def table_to_star(table: cistem.Table, pixel_size: float, voltage: float = 300.0,
                  cs: float = 2.7, w: float = 0.07,
                  image_name_fmt="{i}@stack.mrcs", optics_group: int = 1):
    n = table.n_rows

    def col(name, default=0.0):
        return np.asarray(table[name]) if name in table else np.full(n, default)

    blocks = {
        "optics": {
            "fields": {},
            "loop": {
                "rlnOpticsGroup": np.array([int(optics_group)]),
                "rlnImagePixelSize": np.array([pixel_size]),
                "rlnVoltage": np.array([voltage]),
                "rlnSphericalAberration": np.array([cs]),
                "rlnAmplitudeContrast": np.array([w]),
            },
        },
        "particles": {
            "fields": {},
            "loop": {
                "rlnImageName": np.array(
                    [image_name_fmt.format(i=i + 1) for i in range(n)], dtype=object
                ),
                "rlnOpticsGroup": np.full(n, int(optics_group),
                                          dtype=np.int64),
                "rlnMicrographName": np.array(
                    [f"mic{int(g):05d}.mrc" for g in col("particle_group", 1)],
                    dtype=object,
                ),
                "rlnCoordinateX": col("original_x_position"),
                "rlnCoordinateY": col("original_y_position"),
                "rlnAngleRot": col("phi"),
                "rlnAngleTilt": col("theta"),
                "rlnAnglePsi": col("psi"),
                "rlnOriginXAngst": col("x_shift"),
                "rlnOriginYAngst": col("y_shift"),
                "rlnDefocusU": col("defocus_1"),
                "rlnDefocusV": col("defocus_2"),
                "rlnDefocusAngle": col("defocus_angle"),
                "rlnPhaseShift": np.degrees(col("phase_shift")),
                "rlnClassNumber": col("best_2d_class", 1).astype(np.int64),
                "rlnRandomSubset": col("assigned_subset", 1).astype(np.int64),
                "rlnParticleSelectionScore": col("score"),
            },
        },
    }
    return blocks


def export_star(table: cistem.Table, path, pixel_size: float, **kw):
    star.write(table_to_star(table, pixel_size, **kw), path)


def star_to_table(blocks: dict) -> tuple[cistem.Table, dict]:
    """particles .star -> (.cistem table, optics info dict)."""
    particles = blocks.get("particles") or blocks.get("root") or next(iter(blocks.values()))
    loop = particles["loop"]
    n = len(next(iter(loop.values())))

    def col(name, default=0.0):
        v = loop.get(name)
        if v is None:
            return np.full(n, default)
        return np.asarray(v, dtype=np.float64)

    table = cistem.Table.zeros(n)
    table["position_in_stack"] = np.arange(1, n + 1)
    table["image_is_active"] = np.ones(n)
    table["phi"] = col("rlnAngleRot")
    table["theta"] = col("rlnAngleTilt")
    table["psi"] = col("rlnAnglePsi")
    table["x_shift"] = col("rlnOriginXAngst")
    table["y_shift"] = col("rlnOriginYAngst")
    table["defocus_1"] = col("rlnDefocusU")
    table["defocus_2"] = col("rlnDefocusV")
    table["defocus_angle"] = col("rlnDefocusAngle")
    table["phase_shift"] = np.radians(col("rlnPhaseShift"))
    table["original_x_position"] = col("rlnCoordinateX")
    table["original_y_position"] = col("rlnCoordinateY")
    table["occupancy"] = np.full(n, 100.0)
    table["assigned_subset"] = col("rlnRandomSubset", 0)
    if np.all(table["assigned_subset"] == 0):
        table["assigned_subset"] = np.arange(n) % 2 + 1
    table["best_2d_class"] = col("rlnClassNumber", 1)
    table["score"] = col("rlnParticleSelectionScore")

    optics = {}
    ob = blocks.get("optics")
    if ob:
        ol = ob["loop"]
        for key, name in [
            ("rlnImagePixelSize", "pixel_size"),
            ("rlnVoltage", "voltage"),
            ("rlnSphericalAberration", "cs"),
            ("rlnAmplitudeContrast", "amplitude_contrast"),
        ]:
            if key in ol and len(ol[key]):
                optics[name] = float(np.asarray(ol[key])[0])
    if "pixel_size" in optics:
        table["pixel_size"] = np.full(n, optics["pixel_size"])
    if "voltage" in optics:
        table["microscope_voltage"] = np.full(n, optics["voltage"])
    if "cs" in optics:
        table["microscope_cs"] = np.full(n, optics["cs"])
    if "amplitude_contrast" in optics:
        table["amplitude_contrast"] = np.full(n, optics["amplitude_contrast"])
    return table, optics


def import_star(path) -> tuple[cistem.Table, dict]:
    return star_to_table(star.read(path))
