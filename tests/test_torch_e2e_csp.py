"""The CSP fixture (`tools/e2e_csp`) and the frame the `csp` mode reads a
`tomo` bundle in, on the CPU: the planted rotations rebuild the planted
particles, the Euler conventions round-trip, the start error is what it
says; and on a small `e2e_tomo` series through the port's `tomo` (13
tilts of 384² at 4 Å/px, patch alignment with its 3° axis), a pick where
a perfect picker puts it (the planted centre on the tomogram's voxel grid
plus the tomogram's gauge offset; the picker itself is not reliable at
this size, and the card's run holds the real picks), placed by
`ops.csp.project_positions` with the bundle's xf read as
`pipeline.csp.series_params_from_metadata` reads it, lands on its planted
particle in the raw tilts (the fixture's own projection): within a
quarter of the particle radius at the median, farther with the other xf
sign, and farther with no axis (the JAX package's tomogram ignores the
axis; the port's turns its tilts by it, and CSP takes xf[0, 2]).
"""

import numpy as np
import pytest
import torch

from pyp_tpu_torch.config import schema
from pyp_tpu_torch.io.metadata import ItemMetadata
from pyp_tpu_torch.ops import csp as tcsp
from pyp_tpu_torch.pipeline import csp as tpipe
from pyp_tpu_torch.pipeline import tomo as ttomo
from pyp_tpu_torch.tools import e2e_csp, e2e_tomo

SMALL = dict(size=384, pixel=4.0, tilt_step=10.0, shift_px=4.0,
             n_particles=12, n_beads=8, seed=3)
THICKNESS = 288


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_planted_rotations_and_eulers():
    truth = e2e_tomo.make_truth(**SMALL)[1]
    classes = e2e_tomo.make_truth(**SMALL)[0]
    R = e2e_csp.planted_rotations(truth)
    off = e2e_tomo.particle_offsets(truth["particle_radius"])
    pts = np.asarray(classes["particle"]["points"]).reshape(len(R), 6, 3)
    P = e2e_csp.PERM
    for Rk, c, p in zip(R, np.asarray(truth["particles"]), pts):
        np.testing.assert_allclose(c + off @ (P @ Rk @ P).T, p, atol=1e-9)
        np.testing.assert_allclose(Rk @ Rk.T, np.eye(3), atol=1e-9)
    e = e2e_csp.matrix_to_euler(R)
    np.testing.assert_allclose(e2e_csp.euler_to_matrix(e), R, atol=1e-9)
    # the fixture's euler convention is the port's
    from pyp_tpu_torch.core.geometry import euler_to_matrix

    np.testing.assert_allclose(
        euler_to_matrix(*torch.as_tensor(e, dtype=torch.float64).T).numpy(),
        R, atol=1e-9)
    start = e2e_csp.start_eulers(R, 12.0, seed=1)
    np.testing.assert_allclose(e2e_csp.orientation_errors_deg(start, R), 12.0,
                               atol=1e-3)


@pytest.fixture(scope="module")
def tomo_bundle(tmp_path_factory):
    d = tmp_path_factory.mktemp("series")
    truth, _ = e2e_tomo.write_series(d, device="cpu", **SMALL)
    from pyp_tpu_torch.io import mrc

    p = schema.defaults()
    p.update(scope_pixel=4.0, ctf_tile=128, ctf_min_def=20000.0,
             ctf_max_def=50000.0, tomo_rec_thickness=THICKNESS,
             tomo_rec_binning=8, tomo_ali_patch_size=32,
             tomo_spk_method="auto", tomo_spk_rad=64.0, plot_per_item=False)
    ttomo.process_tilt_series(
        {"name": "ts01", "tilts": mrc.read(d / "ts01.mrc").astype(np.float32),
         "angles": np.loadtxt(d / "ts01.tlt")}, p, d, device="cpu")
    return truth, ItemMetadata("ts01", d, mode="tomo").load(), d


def test_picks_land_on_their_particles_in_the_raw_tilts(tomo_bundle):
    truth, meta, work = tomo_bundle
    from pyp_tpu_torch.io import mrc

    size, pixel = SMALL["size"], SMALL["pixel"]
    binning = meta.scalars["binning"]
    rec = torch.from_numpy(mrc.read(work / "ts01.rec.mrc").astype(np.float32))
    rec_pixel = pixel * binning
    tt = e2e_tomo.truth_tomogram(truth, tuple(rec.shape), rec_pixel,
                                 device="cpu")
    off = e2e_tomo.best_offset(rec, tt, 3)
    planted = np.asarray(truth["particles"])
    vox = e2e_tomo.rec_voxel(planted, tuple(rec.shape), rec_pixel) + off
    picks = e2e_csp.pick_positions(vox, binning, THICKNESS, size)
    idx, _ = e2e_csp.match_picks(picks, truth, pixel)
    np.testing.assert_array_equal(idx, np.arange(len(planted)))
    want = np.stack([np.stack(e2e_tomo.project_positions(
        planted, float(th), truth["axis_angle"], np.asarray(truth["shifts"])[t],
        size, pixel), -1) for t, th in enumerate(truth["angles"])])

    def offsets(meta_like, axis=None):
        cp = tpipe.series_params_from_metadata(
            meta_like, picks, np.zeros((len(picks), 3)), device="cpu")
        if axis is not None:
            cp = cp._replace(axis_angles=torch.full_like(cp.axis_angles, axis))
        got = tcsp.project_positions(cp).numpy() + size // 2
        return np.median(np.hypot(*(got - want).transpose(2, 0, 1)))

    sign = meta.scalars["xf_shift_sign"]
    here = offsets(meta)
    rad_px = truth["particle_radius"] / pixel
    assert here < 0.25 * rad_px, here
    # the other sign: the bundle read as the JAX package reads it
    flipped = ItemMetadata("ts01", "unused", mode="tomo")
    flipped["xf"], flipped["tlt"] = -meta["xf"], meta["tlt"]
    flipped.scalars["xf_shift_sign"] = sign
    assert offsets(flipped) > here + 1.0
    assert offsets(meta, axis=0.0) > here + 1.0
    # the fixture's own placement of the picks agrees
    fix = e2e_csp.projected_offsets(picks, meta["xf"], meta["tlt"], sign,
                                    truth, size)
    assert abs(np.median(fix) - here) < 0.5
