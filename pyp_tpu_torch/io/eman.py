"""EMAN2 interop: HDF image stacks (MDF layout) and .lst/.lsx list files.

The reference's refine/eman role shells out to EMAN2 binaries
(pyp/refine/eman/); its data interchange is EMAN's HDF
stack format and LSX particle lists. Here both are read/written natively so
EMAN-side tools (e2display, e2proc2d, e2initialmodel, ...) can consume
pyp_tpu particles and vice versa.

HDF layout (EMAN2 "MDF" convention):

    /MDF/images                      attrs: imageid_max
    /MDF/images/<i>/image            2-D (or 3-D) float dataset
    /MDF/images/<i>                  attrs: EMAN.apix_x/y/z, EMAN.nx/ny/nz

LSX format: a text header line "#LSX", a comment line, a line with the
fixed per-entry byte length, then fixed-width records
"<index> <path> <comment>".
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_hdf(stack, path, apix: float = 1.0,
              extra_attrs: dict | None = None, volume: bool = False):
    """Write an image stack (N, ny, nx) as EMAN2 HDF. A 3-D array is
    ambiguous — pass volume=True to store it as ONE 3-D image (id 0)
    instead of nz 2-D slices."""
    import h5py

    arr = np.asarray(stack, dtype=np.float32)
    if arr.ndim == 2 or (volume and arr.ndim == 3):
        arr = arr[None]
    with h5py.File(path, "w") as f:
        grp = f.create_group("MDF/images")
        grp.attrs["imageid_max"] = np.int32(len(arr) - 1)
        for i, img in enumerate(arr):
            g = grp.create_group(str(i))
            g.create_dataset("image", data=img)
            ny, nx = img.shape[-2:]
            attrs = {
                "EMAN.apix_x": float(apix), "EMAN.apix_y": float(apix),
                "EMAN.apix_z": float(apix),
                "EMAN.nx": np.int32(nx), "EMAN.ny": np.int32(ny),
                "EMAN.nz": np.int32(img.shape[0] if img.ndim == 3 else 1),
            }
            attrs.update(extra_attrs or {})
            for k, v in attrs.items():
                g.attrs[k] = v
    return str(path)


def read_hdf(path):
    """Read an EMAN2 HDF stack -> (stack (N, ...), apix)."""
    import h5py

    with h5py.File(path, "r") as f:
        grp = f["MDF/images"]
        n = int(grp.attrs.get("imageid_max", len(grp) - 1)) + 1
        imgs = []
        apix = 1.0
        for i in range(n):
            g = grp[str(i)]
            imgs.append(np.asarray(g["image"], dtype=np.float32))
            apix = float(g.attrs.get("EMAN.apix_x", apix))
    return np.stack(imgs), apix


def write_lst(entries, path, comment: str = ""):
    """Write an EMAN2 LSX list: entries = [(index, image_path, comment)].

    LSX records are fixed-width (padded with spaces) so EMAN can seek."""
    lines = [f"{i}\t{p}\t{c}".rstrip() for i, p, c in entries]
    width = max((len(ln) for ln in lines), default=0) + 1
    with open(path, "w") as f:
        f.write("#LSX\n")
        f.write(f"# {comment or 'created by pyp_tpu'}\n")
        f.write(f"# {width}\n")
        for ln in lines:
            f.write(ln.ljust(width - 1) + "\n")
    return str(path)


def read_lst(path):
    """Read an EMAN2 .lst/.lsx -> [(index, image_path, comment)]."""
    out = []
    with open(path) as f:
        for line in f:
            s = line.rstrip("\n").strip()
            if not s or s.startswith("#"):
                continue
            parts = s.split(None, 2)
            idx = int(parts[0])
            img = parts[1] if len(parts) > 1 else ""
            comment = parts[2].rstrip() if len(parts) > 2 else ""
            out.append((idx, img, comment))
    return out


def export_particles_hdf(stack_mrc, out_hdf, apix: float = 1.0):
    """Convenience: particle stack .mrc(s) -> EMAN HDF (the e2proc2d role
    for handing a pyp stack to EMAN)."""
    from pyp_tpu_torch.io import mrc

    stack = np.asarray(mrc.read(stack_mrc), dtype=np.float32)
    if stack.ndim == 2:
        stack = stack[None]
    return write_hdf(stack, out_hdf, apix=apix)
