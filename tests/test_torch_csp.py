"""Parity of pyp_tpu_torch/ops/csp.py (and ops/reconstruct.
accumulate_matrices) with the JAX package on the CPU: the CSP geometry,
the window sampling, the score and its gradient with respect to each
block, and one gradient refinement per mode 0-4. The series is the JAX
tests' own (`tests/test_csp.make_tilt_series`: 7 tilts of 160², 6
particles, box 24 at 2 Å/px), perturbed in the block each mode refines.

Tolerances: geometry and window samples rtol 1e-5 with atol 1e-5 *
max|reference| (float32 in another order), window centres equal; the
score within 1e-5, its gradient rtol 1e-3 with atol 1e-3 * max|reference|
(gathers summed in another order). The refinement compounds: each step
moves the parameters along the normalized gradient, so a difference of
the gradient's last bits grows with the step count; the parameters agree
within 1e-4 of their scale (degrees, pixels) after one step, 5e-4 after
three and 2e-3 after five (defocus: x100, Å), the score within 1e-5. accumulate_matrices: every accumulator voxel within
rtol 1e-4 and atol 1e-4 * max|reference| but at most 0.1% of them, all on
the kx <= 1 planes or the Nyquist shell (a sample there lands on either
Friedel mate, or inside or outside the sphere, by the last bit of its
coordinates, in both packages); and so to the port's euler-pose
`accumulate` (itself held to JAX in test_torch_reconstruct.py) within
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.core.geometry import euler_to_matrix as j_e2m
from pyp_tpu.ops import csp as jcsp
from pyp_tpu.ops import fourier_slice as jfs
from pyp_tpu.ops import reconstruct as jrec
from pyp_tpu.ops.refine3d import make_mask_points
from pyp_tpu_torch.ops import csp as tcsp
from pyp_tpu_torch.ops import fourier_slice as tfs
from pyp_tpu_torch.ops import reconstruct as trec
from tests.test_csp import NBOX, PIXEL, T, make_reference, make_tilt_series

CPU = "cpu"
KW = dict(voltage_kv=300.0, cs_mm=2.7, amplitude_contrast=0.07)
# each mode's perturbation of the truth: (field, amplitude)
PERTURB = {0: ("tilt_angles", 1.0), 1: ("particle_eulers", 4.0),
           2: ("particle_pos", 1.5), 3: ("tilt_shifts", 1.5),
           4: ("defocus_offsets", 300.0)}
SCALE = {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0, 4: 100.0}
STEP_TOL = {1: 1e-4, 3: 5e-4, 5: 2e-3}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(port, ref, rtol=1e-5, atol_rel=1e-5):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    atol = atol_rel * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def to_port(p):
    return tcsp.make_params(*(np.asarray(x) for x in p), device=CPU)


def t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def series():
    vol = make_reference()
    true, images, defocus = make_tilt_series(vol)
    return vol, true, np.asarray(images), np.asarray(defocus)


def perturbed(true, mode, seed=7):
    field, amp = PERTURB[mode]
    x = np.asarray(getattr(true, field))
    off = np.random.RandomState(seed + mode).uniform(-amp, amp, x.shape)
    return true._replace(**{field: jnp.asarray((x + off).astype(np.float32))})


@pytest.fixture(scope="module")
def problem(series):
    """Windows and references of every mode's start, in both packages."""
    vol, true, images, defocus = series
    mask = np.asarray(make_mask_points(NBOX, PIXEL, 60.0, 2.5 * PIXEL))
    Fj = jfs.volume_to_fourier(jnp.asarray(vol))
    Ft = tfs.volume_to_fourier(t(vol))
    out = {}
    for mode in PERTURB:
        pj = perturbed(true, mode)
        xv, wc, va = jcsp.prepare_series_windows(jnp.asarray(images), pj,
                                                 NBOX, jnp.asarray(mask))
        out[mode] = dict(pj=pj, xv=xv, wc=np.asarray(wc), va=np.asarray(va))
    return dict(mask=mask, Fj=Fj, Ft=Ft, modes=out)


def jax_args(pr, mode, defocus):
    m = pr["modes"][mode]
    return (m["pj"], m["xv"], jnp.asarray(m["wc"]), jnp.asarray(defocus),
            jnp.asarray(pr["mask"]), pr["Fj"], jnp.ones(T),
            jnp.asarray(m["va"]))


def port_args(pr, mode, defocus):
    m = pr["modes"][mode]
    return (to_port(m["pj"]), t(m["xv"]), t(m["wc"]), t(defocus),
            t(pr["mask"]), pr["Ft"], torch.ones(T), t(m["va"]))


def test_geometry_matches(series):
    _, true, _, _ = series
    rng = np.random.RandomState(0)
    # a series batch too: every leaf with a leading axis of 2
    batch = true._replace(**{
        k: jnp.stack([getattr(true, k), getattr(true, k)
                      + rng.uniform(-3, 3, getattr(true, k).shape).astype(np.float32)])
        for k in true._fields})
    for p in (true, batch):
        tp = tcsp.CspParams(*(t(x) for x in p))
        for fn in ("project_positions", "particle_depth",
                   "effective_rotations"):
            ref = np.stack([np.asarray(getattr(jcsp, fn)(
                jcsp.CspParams(*(x[i] for x in p))))
                for i in range(2)]) if p is batch else getattr(jcsp, fn)(p)
            close(getattr(tcsp, fn)(tp), ref)
    close(tcsp.tilt_rotation(t(true.tilt_angles), t(true.axis_angles)),
          jcsp.tilt_rotation(true.tilt_angles, true.axis_angles))
    cp = tcsp.csp_particles_for_reconstruction(to_port(true))
    for a, b in zip(cp, jcsp.csp_particles_for_reconstruction(true)):
        close(a, b)


def test_window_samples_match(series, problem):
    _, _, images, _ = series
    for mode, m in problem["modes"].items():
        xv, wc, va = tcsp.prepare_series_windows(
            images, to_port(m["pj"]), NBOX, problem["mask"], device=CPU)
        np.testing.assert_array_equal(wc, m["wc"])
        np.testing.assert_array_equal(va, m["va"])
        close(xv, m["xv"])


def test_score_and_gradient_of_each_block(series, problem):
    """csp_score and its gradient with respect to every block; the port's
    gradient is taken as the refinement takes it, with the mode's reused
    reference gather (u0) and defocus (df0), so the reuse detaches nothing
    the block's gradient needs."""
    _, _, _, defocus = series
    for mode in PERTURB:
        ja = jax_args(problem, mode, defocus)
        pa = port_args(problem, mode, defocus)

        def jscore(p):
            return jcsp.csp_score(p, *ja[1:], NBOX, PIXEL, **KW,
                                  xv_precomputed=True)

        close(tcsp.csp_score(*pa, NBOX, PIXEL, **KW, xv_precomputed=True),
              jscore(ja[0]), rtol=1e-5, atol_rel=1e-5)
        gj = jax.grad(jscore)(ja[0])
        tp, xv, wc, df, mask, Ft, tw, va = pa
        u0 = (tcsp._csp_model_gather(tp, mask, Ft, NBOX)
              if mode in tcsp.SHIFT_MODES else None)
        df0 = (tcsp._csp_df(tp, df, PIXEL)
               if mode in tcsp.CTF_CONST_MODES else None)
        for block in tcsp.MODE_BLOCKS[mode]:
            leaf = getattr(tp, block).clone().requires_grad_(True)
            s = tcsp.csp_score(tp._replace(**{block: leaf}), xv, wc, df, mask,
                               Ft, tw, va, NBOX, PIXEL, **KW,
                               xv_precomputed=True, u=u0, df=df0)
            (g,) = torch.autograd.grad(s, [leaf])
            close(g, getattr(gj, block), rtol=1e-3, atol_rel=1e-3)


@pytest.mark.parametrize("mode", sorted(PERTURB))
def test_refine_mode_matches_jax_step_by_step(series, problem, mode):
    """Runs of 1 and 3 steps held to JAX's, then a run of 5 on its final
    score and its parameters' distance to the truth."""
    _, true, _, defocus = series
    ja = jax_args(problem, mode, defocus)
    pa = port_args(problem, mode, defocus)
    jfn = jax.jit(jcsp._refine_mode_xv, static_argnames=(
        "mode", "n", "pixel_size", "iters", "voltage_kv", "cs_mm",
        "amplitude_contrast", "step_tol", "value_tol"))
    field = PERTURB[mode][0]
    for iters in (1, 3, 5):
        pj, sj = jfn(*ja, mode=mode, n=NBOX, pixel_size=PIXEL, iters=iters,
                     lr=0.3, reg_weight=0.1, **KW)
        pt, st = tcsp._refine_mode_xv(*pa, mode, NBOX, PIXEL, iters, 0.3, 0.1,
                                      **KW)
        tol = STEP_TOL[iters] * SCALE[mode]
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=tol)
        assert abs(float(st) - float(sj)) < 1e-5
    # the 5-step result: both as far from the truth, and no worse a score
    # than the start (the keep-or-revert choice)
    err = lambda p: float(np.abs(np.asarray(getattr(p, field))  # noqa: E731
                                 - np.asarray(getattr(true, field))).mean())
    assert abs(err(pt) - err(pj)) <= 2e-3 * SCALE[mode]
    s0 = float(tcsp._refine_mode_xv(*pa, mode, NBOX, PIXEL, 0, 0.3, 0.1,
                                    **KW)[1])
    assert float(st) >= s0 - 1e-6


@pytest.mark.parametrize("iewald", [0, 1, 2])
def test_accumulate_matrices_matches(iewald, monkeypatch):
    """Matrix-pose insertion (the CSPT path) into accumulators chained
    over two batches. IEWALD 2 patches the port's `ref_amplitude` to 1: the
    JAX package inserts the reference unscaled."""
    if iewald == 2:
        monkeypatch.setattr(tfs, "ref_amplitude",
                            lambda pred, F: torch.ones(F.shape[0]))
    rng = np.random.RandomState(4)
    B = 10
    wins = rng.randn(B, NBOX, NBOX).astype(np.float32)
    eul = rng.uniform(0, 360, (B, 3)).astype(np.float32)
    R = np.asarray(j_e2m(eul[:, 0], eul[:, 1], eul[:, 2]))
    sh = rng.uniform(-2, 2, (B, 2)).astype(np.float32)
    df = rng.uniform(14000, 16000, B).astype(np.float32)
    sub = (np.arange(B) % 2).astype(np.int32)
    w = rng.uniform(0.5, 1.0, B).astype(np.float32)
    ref = jfs.volume_to_fourier(jnp.asarray(make_reference()), pad=2) \
        if iewald == 2 else None
    kw = dict(iewald=iewald, **KW)
    accj = accp = None
    for lo in (0, B // 2):
        sl = slice(lo, lo + B // 2)
        accj = jrec.accumulate_matrices(
            jnp.asarray(wins[sl]), jnp.asarray(R[sl]), jnp.asarray(sh[sl]),
            jnp.asarray(df[sl]), jnp.asarray(sub[sl]), jnp.asarray(w[sl]),
            NBOX, PIXEL, prev=accj, ref_fourier=ref, **kw)
        accp = trec.accumulate_matrices(
            t(wins[sl]), t(R[sl]), t(sh[sl]), t(df[sl]), t(sub[sl]),
            t(w[sl]), NBOX, PIXEL, prev=accp,
            ref_fourier=None if ref is None else t(ref), **kw)
    # a sample on the kx = 0 plane may land on either Friedel mate, and one
    # on the Nyquist ring (|g| = n/2) inside or outside the sphere: the
    # sign or the last bit of a rounded q decides, in both packages. The
    # few voxels that differ lie there; every other voxel agrees
    for a, b in zip(accp, accj):
        agree_off_the_ambiguous_voxels(a.numpy(), np.asarray(b))
    # and the matrix path is the euler path where the poses agree
    poses = t(np.concatenate([eul, sh], 1))
    cp = t(np.stack([df, df, 0 * df, 0 * df], 1))
    ref_acc = None
    for lo in (0, B // 2):
        sl = slice(lo, lo + B // 2)
        ref_acc = trec.accumulate(
            t(wins[sl]), poses[sl], cp[sl], t(sub[sl]).long(), t(w[sl]),
            NBOX, PIXEL, prev=ref_acc,
            ref_fourier=None if ref is None else t(ref), **kw)
    for a, b in zip(accp, ref_acc):
        agree_off_the_ambiguous_voxels(a.numpy(), b.numpy(), tol=1e-5)


def agree_off_the_ambiguous_voxels(a, b, tol=1e-4):
    """Accumulators on the (pn, pn, pn//2+1) grid agree within tol (of the
    largest value and relative) but on at most 0.1% of the voxels, all on
    the kx <= 1 planes or the Nyquist shell."""
    pn = a.shape[0]
    kz = np.fft.fftfreq(pn)[:, None, None] * pn
    kx = np.arange(pn // 2 + 1)[None, None, :]
    r = np.sqrt(kz ** 2 + np.swapaxes(kz, 0, 1) ** 2 + kx ** 2)
    ambiguous = (kx <= 1) | (r >= pn // 2 - 2)
    bad = np.abs(a - b) > tol * np.abs(b).max() + tol * np.abs(b)
    assert bad.sum() <= 1e-3 * bad.size, bad.sum()
    assert not (bad & ~ambiguous).any()
