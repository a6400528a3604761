"""CPU rehearsals of the JAX package's learned models on the fixtures
`chip_smoke.py` holds the port to, at a reduced size: what the reference
algorithm itself reaches, for a bar the port is held to on the card.

    JAX_PLATFORMS=cpu python tools/rehearse_models_jax.py het [per_state] [box]
    JAX_PLATFORMS=cpu python tools/rehearse_models_jax.py nn [size]
    JAX_PLATFORMS=cpu python tools/rehearse_models_jax.py n2n [epochs]

het: `pyp_tpu.models.heterogeneity.train_heterogeneity` at the schema's
defaults on `pyp_tpu_torch.tools.e2e_class.two_state_dataset` (the
classify3d phase's two states, consensus poses) with `per_state`
particles a state (default 512) at box `box` (default 128); prints the
latents' PC1 purity and the decoded state maps' cc with the states.

nn: `pyp_tpu.models.picker.train_picker` at the `sprtrain` mode's
settings (300 steps, batch 16, patch 128, widths 8-16-32) on two
`tools/e2e_spr` micrographs of `size`² (default 1024; 8 frames, the
port's `spr` mode on the CPU gives the averages and the size-based picks
it trains on), then `infer_heatmap` + `pick_from_heatmap` on the third:
recall and precision within one particle radius of the planted centres.

n2n: the JAX package's `process_tilt_series` with `-denoise_method n2n`
(`epochs` steps, default the schema's 60) on
tests/test_torch_tomo_pipeline.py's small planted series (13 tilts of
384² at 4 Å/px): the slab cc with the planted truth of the tomogram and
of the denoised tomogram.

Prints one JSON line; every number is a CPU reading of the JAX package,
not a device measurement.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def rehearse_het(per_state=512, box=128):
    from pyp_tpu.models import heterogeneity as het
    from pyp_tpu_torch.tools import e2e_class

    t0 = time.perf_counter()
    d = e2e_class.two_state_dataset(per_state=per_state, box=box,
                                    device="cpu")
    poses = np.stack([d["phi"], d["theta"], d["psi"], -d["shifts"][:, 0],
                      -d["shifts"][:, 1]], 1).astype(np.float32)
    model = het.train_heterogeneity(d["stack"], poses, d["ctf_params"], 1.0)
    z = het.embed(model, d["stack"])
    pc, _, _ = het.latent_pca(z, 1)
    low = (pc[:, 0] <= np.median(pc[:, 0])).astype(int)
    purity = e2e_class.purity(low, d["labels"])
    maps = [het.decode_volume(model, z[d["labels"] == k].mean(0))
            for k in (0, 1)]
    va, vb = d["volumes"]
    cc = e2e_class.cc
    return {"rehearsal": "het", "per_state": per_state, "box": box,
            "purity": purity,
            "matched": cc(maps[0], va) + cc(maps[1], vb),
            "crossed": cc(maps[0], vb) + cc(maps[1], va),
            "seconds": time.perf_counter() - t0}


def rehearse_nn(size=1024):
    import contextlib
    import io
    import os
    import tempfile

    from pyp_tpu.models import picker
    from pyp_tpu_torch import cli
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.tools import e2e_spa, e2e_spr

    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp())
    volume = e2e_spa.make_dataset(n_particles=1, device="cpu")["volume"]
    kw = dict(e2e_spr.MOVIES)
    kw.update(n_movies=3, n_frames=8, size=size, dose=5.0)
    truth, _ = e2e_spr.write_movies(root / "movies", volume, device="cpu",
                                    **kw)
    work = root / "project"
    work.mkdir()
    here = os.getcwd()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(e2e_spr.SPR_ARGS + [
                "-data_path", str(root / "movies" / "movie_*.mrc"),
                "-movie_large_threshold_mpix", "1", "-scope_dose_rate",
                "5.0"], device="cpu")
    finally:
        os.chdir(here)
    names = sorted(truth)
    metas = [ItemMetadata(n, work).load() for n in names]
    radius = int(e2e_spr.PARTICLE_RADIUS_A)
    model = picker.train_picker([m["average"] for m in metas[:2]],
                                [m["box"][:, :2] for m in metas[:2]],
                                radius, patch=128, steps=300, batch=16,
                                features=(8, 16, 32))
    heat = picker.infer_heatmap(model, metas[2]["average"],
                                features=(8, 16, 32))
    coords, _, valid = picker.pick_from_heatmap(heat, radius, 0.3, 1024)
    recall, precision = e2e_spr.pick_recall_precision(
        coords[valid], truth[names[2]]["centres"], radius)
    auto = e2e_spr.pick_recall_precision(
        metas[2]["box"][:, :2], truth[names[2]]["centres"], radius)
    return {"rehearsal": "nn", "size": size,
            "planted": len(truth[names[2]]["centres"]),
            "picks": int(valid.sum()), "recall": recall,
            "precision": precision, "heat_max": float(heat.max()),
            "heat_mean": float(heat.mean()),
            "auto_picker_recall_precision": list(auto),
            "seconds": time.perf_counter() - t0}


def rehearse_n2n(epochs=60):
    import tempfile

    import torch

    from pyp_tpu.config import schema
    from pyp_tpu.io import mrc
    from pyp_tpu.pipeline import tomo
    from pyp_tpu_torch.tools import e2e_tomo

    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp())
    small = dict(size=384, pixel=4.0, tilt_step=10.0, shift_px=4.0,
                  n_particles=12, n_beads=8, seed=3)
    truth, _ = e2e_tomo.write_series(root / "data", device="cpu", **small)
    params = schema.defaults()
    params.update(scope_pixel=4.0, ctf_tile=128, ctf_min_def=20000.0,
                  ctf_max_def=50000.0, tomo_rec_thickness=288,
                  tomo_rec_binning=8, tomo_ali_patch_size=32,
                  tomo_spk_method="none", plot_per_item=False,
                  tomo_ali_patches=0, denoise_method="n2n",
                  denoise_epochs=epochs)
    item = {"name": "ts01",
            "tilts": mrc.read(root / "data" / "ts01.mrc").astype(np.float32),
            "angles": np.asarray(truth["angles"], np.float32)}
    work = root / "work"
    work.mkdir()
    tomo.process_tilt_series(item, params, work)
    out = {}
    for tag in ("rec", "den"):
        vol = torch.as_tensor(mrc.read(work / f"ts01.{tag}.mrc")
                              .astype(np.float32))
        ref = e2e_tomo.truth_tomogram(truth, tuple(vol.shape), 24.0,
                                      device="cpu")
        off = e2e_tomo.best_offset(vol, ref, 4)
        out[f"{tag}_cc"] = float(e2e_tomo.slab_cc(vol, ref, off, half=8))
    return {"rehearsal": "n2n", "epochs": epochs, **out,
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    what, args = sys.argv[1], [int(a) for a in sys.argv[2:]]
    print(json.dumps({"het": rehearse_het, "nn": rehearse_nn,
                      "n2n": rehearse_n2n}[what](*args)), flush=True)
