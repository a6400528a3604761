"""Per-item metadata store — the port's own copy of pyp_tpu/io/metadata.py
(the equivalent of the reference's per-micrograph pickle bundles,
`LocalMetadata` with its declarative FILES_SPR / FILES_TOMO schemas).

Design: one `<name>.meta.npz` per micrograph / tilt-series holding named numpy
arrays (drift trajectories, ctf fits, box coordinates, tilt angles, ...),
plus a JSON sidecar of scalars. Entries carry a declarative schema so stages
can test `is_done` and `refresh` can selectively invalidate (the reference's
`_force` flag cascade). The bundle is the resume state: either package
reads what the other wrote. Unlike the JAX package's class, `load` reads
only the bundle's directory; an entry is decompressed when it is first
asked for, so a resumed item that needs no stage does not pay for its
camera-sized average.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

# entry name -> (description, force_flag) ; force flag names mirror the
# user-facing parameters that invalidate the entry when toggled.
SCHEMA_SPR = {
    "drift": ("per-frame drift trajectory (n_frames, 2)", "movie_force"),
    "average": ("drift-corrected average", "movie_force"),
    "patch_shifts": ("per-patch local motion", "movie_force"),
    "ctf": ("global CTF fit vector", "ctf_force"),
    "ctf_avgrot": ("radially averaged spectrum table", "ctf_force"),
    "ctf_thickness": ("sample thickness fit [Å, score]", "ctf_force"),
    "ctf_plane": ("local defocus plane [df0, ddf/dy, ddf/dx]", "ctf_force"),
    "ctf_diag": ("CTFFIND-style diagnostic image", "ctf_force"),
    "box": ("particle coordinates (n, 4+)", "detect_force"),
    "denoised": ("denoised average", "denoise_force"),
    "image_mean": ("micrograph statistics", "movie_force"),
}
SCHEMA_TOMO = {
    "drift": ("per-tilt per-frame drift (n_tilts, n_frames, 2)", "movie_force"),
    "tlt": ("tilt angles (n_tilts,)", "tomo_ali_force"),
    "xf": ("2D alignment transforms (n_tilts, 6)", "tomo_ali_force"),
    "fid": ("tracked gold fiducials", "tomo_ali_force"),
    "ctf": ("per-tilt CTF fits (n_tilts, k)", "ctf_force"),
    "box": ("3D particle coordinates", "tomo_spk_force"),
    "vir": ("virion centers/radii", "tomo_vir_force"),
    "spk": ("surface spike picks", "tomo_spk_force"),
    "spk_eulers": ("surface-normal orientation priors", "tomo_spk_force"),
    "exclude": ("excluded tilt indices", "tomo_ali_force"),
}


class ItemMetadata:
    """Metadata bundle for one micrograph or tilt-series. `arrays` holds
    the entries set or read so far; `entries()` names all of them."""

    def __init__(self, name: str, directory=".", mode: str = "spr"):
        self.name = name
        self.directory = Path(directory)
        self.mode = mode
        self.schema = SCHEMA_SPR if mode == "spr" else SCHEMA_TOMO
        self.arrays: dict[str, np.ndarray] = {}
        self.scalars: dict = {}
        self._on_disk: set[str] = set()   # entries of the .npz not read yet

    @property
    def npz_path(self) -> Path:
        return self.directory / f"{self.name}.meta.npz"

    @property
    def json_path(self) -> Path:
        return self.directory / f"{self.name}.meta.json"

    def exists(self) -> bool:
        return self.npz_path.exists()

    def load(self) -> "ItemMetadata":
        self.arrays, self._on_disk = {}, set()
        if self.npz_path.exists():
            with np.load(self.npz_path, allow_pickle=False) as z:
                self._on_disk = set(z.files)
        if self.json_path.exists():
            self.scalars = json.loads(self.json_path.read_text())
        return self

    def _read(self, keys):
        keys = [k for k in keys if k in self._on_disk]
        if keys:
            with np.load(self.npz_path, allow_pickle=False) as z:
                for k in keys:
                    self.arrays[k] = z[k]
            self._on_disk.difference_update(keys)

    def entries(self) -> set:
        return set(self.arrays) | self._on_disk

    def save(self):
        self._read(sorted(self._on_disk))
        self.directory.mkdir(parents=True, exist_ok=True)
        tmp = str(self.npz_path) + ".tmp.npz"
        np.savez_compressed(tmp, **self.arrays)
        os.replace(tmp, self.npz_path)
        self.json_path.write_text(json.dumps(self.scalars, indent=1, default=float))

    def is_done(self, entry: str) -> bool:
        return entry in self.arrays or entry in self._on_disk

    def refresh(self, params: dict):
        """Drop entries whose force flag is set in `params` (idempotent resume:
        only invalidated stages re-run; mirrors reference refresh_entries)."""
        dropped = []
        for entry, (_, flag) in self.schema.items():
            if params.get(flag, False) and self.is_done(entry):
                self.arrays.pop(entry, None)
                self._on_disk.discard(entry)
                dropped.append(entry)
        return dropped

    def __setitem__(self, key, value):
        self.arrays[key] = np.asarray(value)
        self._on_disk.discard(key)

    def __getitem__(self, key):
        self._read([key])
        return self.arrays[key]

    def __contains__(self, key):
        return self.is_done(key)
