"""Synthetic tilt series for the tomography path, and its ground-truth
scoring — written without calling the code under test.

The specimen is a set of clouds of isotropic 3D Gaussian points, each
class with its own width and signed weight, the contrast it shows in the
images and the tomogram (negative is dark; centred coordinates in Å,
(z, y, x)):

  particles  `n_particles` copies of one asymmetric cloud (6 points
             0.2-0.45 R from the centre, width 0.45 R, R =
             `particle_radius`; `particle_spread` and `particle_sigma` set
             the distances and the width in units of R: `CSP_SERIES` plants
             a sharper, wider cloud whose projections change with its
             orientation),
             each turned by a random rotation, on a jittered grid at
             heights within `height` x the half thickness of mid-height
             (`SERIES` keeps them in a thin layer: a tracked patch follows
             the content of one height, and content at other heights
             moves across its window at high tilt; `THICK_SERIES` spreads
             them through the thickness); planted BRIGHT (positive
             weight), the polarity the `auto` slab picker looks for;
  virions    `virion_radii` shells: Fibonacci points 25 Å apart on spheres
             of known radius centred at mid-height, width 20 Å, dark;
  crowd      small specks (2 per (100 Å)², width 30 Å) all over the field
             within +-0.5% of the thickness of mid-height (+-`layer` x the
             thickness where `layer` is given), faint and bright: the
             texture the patch tracker follows;
  beads      `n_beads` gold beads of radius `bead_radius` (10 nm across)
             mixed into the specimen within two radii of mid-height
             (+-`layer` x the thickness where it is given), one point
             each, width radius / 2, strongly dark;
  filament   one straight rod along y at mid-height, points 20 Å apart
             on its axis, width 60 Å, dark (its counts dip by about 40%
             at the zero tilt and never reach zero);
  sheet      one flat membrane patch, points 25 Å apart on a plane whose
             normal lies in the x-z plane 60° from z, width 20 Å, dark.

Image formation per tilt theta (41 tilts from -60° to 60° in 3° steps):
each point projects analytically, x' = x cos(theta) + z sin(theta) about
y, then the in-plane tilt-axis rotation by `axis_angle` (3°:
y2 = sin(a) x' + cos(a) y, x2 = cos(a) x' - sin(a) y, the projection
model of `ops.tomo`), then the content moves by minus the planted
aligning shift s_t (uniform in +-`shift_px` unbinned px, 0 at the zero
tilt). The points splat bilinearly onto one canvas per class, each
canvas is blurred by its Gaussian as an rFFT multiply, white "ice" noise
is added (`ice` x the specimen's std), and the CTF is applied with the
planted per-tilt defocus (uniform in [3.0, 4.0] µm at the tilt axis) and
the planted hand's defocus gradient across x, df(x) = df_t + hand * x *
tan(theta), in 32 column bands, with the sign that keeps low-resolution
contrast as planted; the image is scaled to `contrast` std
and sampled as Poisson counts at `dose` e/px. `ts01.mrc` holds the counts
as MRC mode 1 (int16) and `ts01.tlt` the angles. The movie path writes
instead one 4-frame int8 movie per tilt (the same rate split over the
frames, each frame moved along a planted drift) and a SerialEM `.mdoc`.

The truth tomogram renders the same clouds on the reconstruction grid
(trilinear splat + 3D Gaussian blur). Everything random comes from one
`numpy.random.RandomState(seed)` (layout, rotations, shifts, defoci,
drift) and one seeded `torch.Generator` on the device (ice, counts).

It is a fixture for the smoke run and the tests, not a user feature.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from pyp_tpu_torch import resolve_device

# the smoke run's series: K3-size tilts at 1 Å/px, the schema's default
# particle radius (tomo_spk_rad 100 Å), virions of 300 Å radius (above
# the top row of the tracked patches), a 2,048 Å thick reconstruction
# (tomo_rec_thickness at 1 Å/px)
SERIES = dict(size=4096, pixel=1.0, tilt_min=-60.0, tilt_max=60.0,
              tilt_step=3.0, axis_angle=3.0, shift_px=40.0,
              df_min=30000.0, df_max=40000.0, hand=1, thickness=2048.0,
              particle_radius=100.0, n_particles=60,
              virion_radii=(280.0, 300.0, 320.0), bead_radius=50.0,
              n_beads=24, height=0.06, layer=None, dose=50.0, contrast=0.5,
              ice=0.1, seed=0)
# the same field with its content spread through the thickness: particles
# within 80% of the half thickness of mid-height, the texture and the
# beads within +-35% of the thickness (the known limit of patch tracking,
# read without bars)
THICK_SERIES = dict(SERIES, height=0.8, layer=0.35)
# the CSP run's field: the same series with a particle that carries its
# orientation at the band CSP refines in (6 Gaussians of 20 Å, 40-70 Å from
# the centre; the default cloud, 45 Å Gaussians within 45 Å, projects the
# same within 0.15% up to a 30° turn)
CSP_SERIES = dict(SERIES, particle_spread=(0.4, 0.7), particle_sigma=0.2)
# the tomography run's flags on top of the schema's defaults
TOMO_ARGS = ["tomo", "-scope_pixel", "1.0", "-scope_voltage", "300",
             "-scope_cs", "2.7", "-scope_wgh", "0.07",
             "-tomo_spk_method", "auto", "-ctf_min_def", "20000",
             "-ctf_max_def", "50000"]
MOVIE_FRAMES, MOVIE_DRIFT_PX = 4, 6.0
CTF_BANDS = 32     # column bands of the defocus gradient
VOLTAGE_KV, CS_MM, AMP_CONTRAST = 300.0, 2.7, 0.07


def tilt_angles(tilt_min=-60.0, tilt_max=60.0, tilt_step=3.0):
    return np.arange(tilt_min, tilt_max + 0.5 * tilt_step,
                     tilt_step).astype(np.float32)


def _fibonacci(n):
    idx = np.arange(n) + 0.5
    z = 1 - 2 * idx / n
    r = np.sqrt(1 - z * z)
    ga = np.pi * (1 + 5 ** 0.5) * idx
    return np.stack([z, r * np.sin(ga), r * np.cos(ga)], 1)


def _rotation(rng):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    a, b, c, d = q
    return np.array([
        [a*a + b*b - c*c - d*d, 2*(b*c - a*d), 2*(b*d + a*c)],
        [2*(b*c + a*d), a*a - b*b + c*c - d*d, 2*(c*d - a*b)],
        [2*(b*d - a*c), 2*(c*d + a*b), a*a - b*b - c*c + d*d]])


def particle_offsets(radius, seed=1, spread=(0.2, 0.45)):
    """The canonical particle cloud: 6 offsets (z, y, x) in Å between
    spread[0] and spread[1] x R of the centre (the same for every seed of
    the layout)."""
    rng = np.random.RandomState(seed)
    off = rng.uniform(-1, 1, (6, 3))
    off = off / np.linalg.norm(off, axis=1, keepdims=True)
    off *= rng.uniform(spread[0], spread[1], (6, 1)) * radius
    return off - off.mean(0)


def layout(field, thickness, particle_radius=100.0, n_particles=60,
           virion_radii=(280.0, 300.0, 320.0), bead_radius=50.0,
           n_beads=24, height=0.06, layer=None, rng=None,
           particle_spread=(0.2, 0.45), particle_sigma=0.45):
    """The specimen: a dict of classes {"points" (N, 3) Å (z, y, x),
    "weight" per point, "sigma" Å} and the planted truth of each object.
    `field` is the image's side in Å; the objects keep 5% of it clear of
    the edges: virions along the top (+y) band, particles in the middle,
    the filament and the sheet at the bottom."""
    rng = rng or np.random.RandomState(0)
    h = 0.5 * field
    half_t = 0.5 * thickness
    classes, truth = {}, {}

    # virions: shells spread along x in the top band
    nv = len(virion_radii)
    rmax = max(virion_radii) if nv else 0.0
    xs_v = np.linspace(-h + 0.05 * field + rmax, h - 0.05 * field - rmax, nv) \
        if nv > 1 else np.zeros(nv)
    yc_v = h - 0.05 * field - rmax
    pts, centres = [], []
    for r, xc in zip(virion_radii, xs_v):
        c = np.array([0.0, yc_v, xc])
        n = int(4 * np.pi * r * r / 25.0 ** 2)
        pts.append(c + r * _fibonacci(n))
        centres.append(c)
    classes["virion"] = dict(points=np.concatenate(pts) if pts else
                             np.zeros((0, 3)), weight=-0.09, sigma=20.0)
    truth["virions"] = [{"centre": c.tolist(), "radius": float(r)}
                        for c, r in zip(centres, virion_radii)]

    # particles: a jittered grid in the middle band, random heights
    y_lo, y_hi = -h + 0.3 * field, yc_v - rmax - 3 * particle_radius
    x_lo, x_hi = -h + 0.05 * field + particle_radius, h - 0.05 * field - particle_radius
    n_cols = max(1, int(round(np.sqrt(n_particles * (x_hi - x_lo)
                                      / max(y_hi - y_lo, 1.0)))))
    n_rows = int(np.ceil(n_particles / n_cols))
    gy, gx = np.meshgrid(np.linspace(y_lo, y_hi, n_rows),
                         np.linspace(x_lo, x_hi, n_cols), indexing="ij")
    cell = min((y_hi - y_lo) / max(n_rows - 1, 1), (x_hi - x_lo) / max(n_cols - 1, 1))
    grid = np.stack([gy.ravel(), gx.ravel()], 1)[:n_particles]
    grid = grid + rng.uniform(-0.15, 0.15, grid.shape) * cell
    zs = rng.uniform(-height, height, len(grid)) * (half_t - 2 * particle_radius)
    off = particle_offsets(particle_radius, spread=particle_spread)
    pts, centres = [], []
    for (y, x), z in zip(grid, zs):
        c = np.array([z, y, x])
        pts.append(c + off @ _rotation(rng).T)
        centres.append(c)
    classes["particle"] = dict(points=np.concatenate(pts), weight=1.0,
                               sigma=particle_sigma * particle_radius)
    truth["particles"] = np.asarray(centres).tolist()

    # filament: a rod along y lying in the specimen in the bottom band,
    # between the columns of tracked patches (a rod along x, constant
    # along the tilt direction, would vanish under the ramp filter but for
    # its ends)
    x_f = -0.15 * field
    y_f = np.arange(-h + 0.07 * field, -h + 0.28 * field, 20.0)
    z_f = rng.uniform(-0.02, 0.02) * thickness
    classes["filament"] = dict(
        points=np.stack([np.full_like(y_f, z_f), y_f, np.full_like(y_f, x_f)], 1),
        weight=-0.5, sigma=60.0)
    truth["filament"] = {"p0": [z_f, float(y_f[0]), x_f],
                         "p1": [z_f, float(y_f[-1]), x_f]}

    # sheet: a flat patch in the bottom band, normal 60° from z in x-z
    normal = np.array([np.cos(np.radians(60.0)), 0.0, np.sin(np.radians(60.0))])
    u = np.array([0.0, 1.0, 0.0])                      # in-plane along y
    v = np.cross(normal, u)                            # in-plane in x-z
    c_s = np.array([0.0, -h + 0.09 * field, 0.0])
    su = np.arange(-0.035 * field, 0.035 * field, 25.0)
    sv = np.arange(-0.8 * half_t, 0.8 * half_t, 25.0)
    uu, vv = np.meshgrid(su, sv, indexing="ij")
    sheet = c_s + uu.reshape(-1, 1) * u + vv.reshape(-1, 1) * v
    classes["sheet"] = dict(points=sheet, weight=-0.09, sigma=20.0)
    truth["sheet"] = {"centre": c_s.tolist(), "normal": normal.tolist(),
                      "u": u.tolist(), "v": v.tolist(),
                      "half_u": float(su[-1]), "half_v": float(sv[-1]),
                      "sigma": 20.0}

    # crowding: small faint densities all over the field at mid-height,
    # the texture that patch tracking follows (bright, so that the gaps
    # between the particles are not dark channels)
    n_crowd = int(2.0 * (field / 100.0) ** 2)
    crowd_z = 0.005 if layer is None else layer
    crowd_pts = np.stack([
        rng.uniform(-crowd_z, crowd_z, n_crowd) * thickness,
        rng.uniform(-h, h, n_crowd), rng.uniform(-h, h, n_crowd)], 1)
    classes["crowd"] = dict(points=crowd_pts, weight=0.2, sigma=30.0)

    # gold beads mixed into the specimen near mid-height (the bead tracker
    # predicts each bead at the height of the tilt axis), anywhere in the
    # field
    by = rng.uniform(-h + 0.05 * field, h - 0.05 * field, n_beads)
    bx = rng.uniform(-h + 0.05 * field, h - 0.05 * field, n_beads)
    bz = (rng.uniform(-2.0, 2.0, n_beads) * bead_radius if layer is None
          else rng.uniform(-layer, layer, n_beads) * thickness)
    beads = np.stack([bz, by, bx], 1)
    classes["bead"] = dict(points=beads, weight=-3.0, sigma=0.5 * bead_radius)
    truth["beads"] = beads.tolist()
    return classes, truth


def _splat2d(canvas, y, x, w):
    """Bilinear splat of weights w at pixel coordinates (y, x) onto a 2D
    canvas (taps outside are dropped)."""
    ny, nx = canvas.shape
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy < ny) & (xx >= 0) & (xx < nx)
            canvas.view(-1).index_add_(0, (yy * nx + xx)[ok], (w * wy * wx)[ok])


def _gauss_2d(ny, nx, sigma_px, dev):
    fy = torch.fft.fftfreq(ny, device=dev)[:, None]
    fx = torch.fft.rfftfreq(nx, device=dev)[None, :]
    return torch.exp(-2.0 * math.pi ** 2 * sigma_px ** 2 * (fy * fy + fx * fx))


def _ctf(ny, nx, pixel, df, dev):
    """The phase-contrast transfer at defocus df (Å) on an rfft grid (the
    textbook CTF, written out here), with the sign that keeps a weight's
    low-resolution contrast as planted: sin(chi + amplitude phase)."""
    lam = 12.2643247 / math.sqrt(VOLTAGE_KV * 1e3 * (1 + VOLTAGE_KV * 0.978466e-3))
    fy = torch.fft.fftfreq(ny, d=pixel, device=dev)[:, None]
    fx = torch.fft.rfftfreq(nx, d=pixel, device=dev)[None, :]
    g2 = fy * fy + fx * fx
    chi = (math.pi * lam * df * g2
           - 0.5 * math.pi * CS_MM * 1e7 * lam ** 3 * g2 * g2)
    amp = math.atan2(AMP_CONTRAST, math.sqrt(1 - AMP_CONTRAST ** 2))
    return torch.sin(chi + amp)


def project_positions(points, theta_deg, axis_deg, shift, size, pixel):
    """Pixel coordinates (y, x) of 3D points (z, y, x) in Å at one tilt:
    tilt about y, the in-plane axis rotation, then minus the aligning
    shift (px)."""
    th, a = math.radians(theta_deg), math.radians(axis_deg)
    xr = points[:, 2] * math.cos(th) + points[:, 0] * math.sin(th)
    yr = points[:, 1]
    y2 = math.sin(a) * xr + math.cos(a) * yr
    x2 = math.cos(a) * xr - math.sin(a) * yr
    c = size // 2
    return y2 / pixel + c - shift[0], x2 / pixel + c - shift[1]


def expected_rates(classes, angles, shifts, defoci, size, pixel, axis_angle,
                   hand, contrast, ice, dose, gen, dev):
    """Per tilt, the expected counts per pixel (a float32 tensor (size,
    size)): a generator over the tilts."""
    pts = {k: torch.as_tensor(np.asarray(c["points"]), dtype=torch.float32,
                              device=dev) for k, c in classes.items()}
    blur = {k: _gauss_2d(size, size, c["sigma"] / pixel, dev)
            for k, c in classes.items()}
    xs_a = (torch.arange(size, device=dev, dtype=torch.float32) - size // 2) * pixel
    for t, theta in enumerate(angles):
        F = None
        for k, c in classes.items():
            if not len(pts[k]):
                continue
            canvas = torch.zeros((size, size), dtype=torch.float32, device=dev)
            y, x = project_positions(pts[k], float(theta), axis_angle,
                                     shifts[t], size, pixel)
            _splat2d(canvas, y, x, torch.full_like(y, c["weight"]))
            Fk = torch.fft.rfft2(canvas) * blur[k]
            F = Fk if F is None else F + Fk
        spec = torch.fft.irfft2(F, s=(size, size))
        noise = torch.randn((size, size), generator=gen, device=dev)
        F = F + torch.fft.rfft2(ice * spec.std() * noise)
        del spec, noise
        # the defocus gradient across x, in column bands
        df_col = float(defoci[t]) + hand * xs_a * math.tan(math.radians(float(theta)))
        edges = torch.linspace(float(df_col.min()), float(df_col.max()) + 1.0,
                               CTF_BANDS + 1, device=dev)
        band = torch.clamp(torch.bucketize(df_col, edges) - 1, 0, CTF_BANDS - 1)
        img = torch.zeros((size, size), dtype=torch.float32, device=dev)
        for b in range(CTF_BANDS):
            cols = band == b
            if not bool(cols.any()):
                continue
            df_mid = 0.5 * float(edges[b] + edges[b + 1])
            img[:, cols] = torch.fft.irfft2(F * _ctf(size, size, pixel, df_mid, dev),
                                            s=(size, size))[:, cols]
        img *= contrast / img.std()
        yield dose * torch.clamp(1.0 + img, min=0.0)


def make_truth(size=4096, pixel=1.0, tilt_min=-60.0, tilt_max=60.0,
               tilt_step=3.0, axis_angle=3.0, shift_px=40.0,
               df_min=30000.0, df_max=40000.0, hand=1, thickness=2048.0,
               particle_radius=100.0, n_particles=60,
               virion_radii=(280.0, 300.0, 320.0), bead_radius=50.0,
               n_beads=24, height=0.06, layer=None, dose=50.0, contrast=0.5,
               ice=0.1, seed=0, particle_spread=(0.2, 0.45),
               particle_sigma=0.45):
    """The planted layout and per-tilt parameters (numpy, no device)."""
    rng = np.random.RandomState(seed)
    angles = tilt_angles(tilt_min, tilt_max, tilt_step)
    classes, objects = layout(size * pixel, thickness, particle_radius,
                              n_particles, virion_radii, bead_radius,
                              n_beads, height, layer, rng=rng,
                              particle_spread=particle_spread,
                              particle_sigma=particle_sigma)
    shifts = rng.uniform(-shift_px, shift_px, (len(angles), 2))
    shifts -= shifts[int(np.argmin(np.abs(angles)))]
    defoci = rng.uniform(df_min, df_max, len(angles))
    drift = rng.uniform(-1, 1, (len(angles), 2))
    truth = dict(size=size, pixel=pixel, angles=angles.tolist(),
                 axis_angle=axis_angle, shifts=shifts.tolist(),
                 defoci=defoci.tolist(), hand=hand, thickness=thickness,
                 particle_radius=particle_radius, bead_radius=bead_radius,
                 movie_drift_dir=drift.tolist(), height=height, layer=layer,
                 seed=seed, particle_spread=list(particle_spread),
                 particle_sigma=particle_sigma,
                 **objects)
    return classes, truth, dict(dose=dose, contrast=contrast, ice=ice,
                                seed=seed)


def write_series(out_dir, name="ts01", movies=False, device="cuda", **kw):
    """Write the series under `out_dir`: `<name>.mrc` (mode 1 counts) +
    `<name>.tlt`, or with `movies`, one 4-frame int8 movie per tilt and
    `<name>.mdoc`; and truth.json. Returns (truth dict, bytes written)."""
    from pyp_tpu_torch.io import mrc

    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    classes, truth, image = make_truth(**kw)
    size, pixel = truth["size"], truth["pixel"]
    angles = np.asarray(truth["angles"], np.float32)
    gen = torch.Generator(device=dev).manual_seed(image["seed"])
    rates = expected_rates(classes, angles, np.asarray(truth["shifts"]),
                           truth["defoci"], size, pixel, truth["axis_angle"],
                           truth["hand"], image["contrast"], image["ice"],
                           image["dose"], gen, dev)
    nbytes = 0
    if not movies:
        stack = np.empty((len(angles), size, size), np.int16)
        for t, rate in enumerate(rates):
            stack[t] = torch.poisson(rate, generator=gen).to(torch.int16).cpu().numpy()
        mrc.write(stack, out_dir / f"{name}.mrc", pixel_size=pixel)
        np.savetxt(out_dir / f"{name}.tlt", angles, fmt="%.2f")
        nbytes += (out_dir / f"{name}.mrc").stat().st_size
    else:
        from pyp_tpu_torch.core.fft import shift_images

        # acquisition order: dose-symmetric from the zero tilt
        order = np.argsort(np.abs(angles), kind="stable")
        zvalue = np.empty(len(angles), int)
        zvalue[order] = np.arange(len(angles))
        lines = [f"PixelSpacing = {pixel}", "ImageFile = " + name + ".st", ""]
        sections = {}
        for t, rate in enumerate(rates):
            traj = (np.linspace(-0.5, 0.5, MOVIE_FRAMES)[:, None]
                    * MOVIE_DRIFT_PX * np.asarray(truth["movie_drift_dir"][t]))
            frames = shift_images(
                (rate / MOVIE_FRAMES)[None].expand(MOVIE_FRAMES, -1, -1),
                torch.as_tensor(traj, dtype=torch.float32, device=dev))
            counts = torch.clamp(torch.poisson(torch.clamp(frames, min=0.0),
                                               generator=gen), max=127)
            movie = f"{name}_{t:03d}.mrc"
            mrc.write(counts.to(torch.int8).cpu().numpy(), out_dir / movie,
                      pixel_size=pixel)
            nbytes += (out_dir / movie).stat().st_size
            sections[int(zvalue[t])] = (
                f"[ZValue = {int(zvalue[t])}]\nTiltAngle = {angles[t]:.2f}\n"
                f"ExposureDose = {image['dose']:.3f}\n"
                f"SubFramePath = X:\\frames\\{movie}\n")
        lines += [sections[z] for z in sorted(sections)]
        (out_dir / f"{name}.mrc.mdoc").write_text("\n".join(lines))
    (out_dir / "truth.json").write_text(json.dumps(truth))
    return truth, nbytes


# ---------------------------------------------------------------------------
# the truth tomogram and scoring
# ---------------------------------------------------------------------------

def rec_voxel(points_a, shape, rec_pixel):
    """Voxel coordinates (z, y, x) on a (nz, ny, nx) reconstruction grid
    (centre at n//2, as the backprojection puts it) of points in Å."""
    return (np.asarray(points_a, np.float64) / rec_pixel
            + np.array([s // 2 for s in shape]))


def render(classes, shape, rec_pixel, device="cuda"):
    """Point classes rendered on a (nz, ny, nx) grid of `rec_pixel` Å
    voxels (centre at n//2): each class's points splat trilinearly, blurred
    by their 3D Gaussian. Returns a tensor."""
    dev = resolve_device(device)
    nz, ny, nx = shape
    kz = torch.fft.fftfreq(nz, device=dev)[:, None, None]
    ky = torch.fft.fftfreq(ny, device=dev)[None, :, None]
    kx = torch.fft.rfftfreq(nx, device=dev)[None, None, :]
    k2 = kz * kz + ky * ky + kx * kx
    lim = torch.tensor(shape, device=dev)
    F = torch.zeros((nz, ny, nx // 2 + 1), dtype=torch.complex64, device=dev)
    for c in classes.values():
        if not len(c["points"]):
            continue
        p = torch.as_tensor(rec_voxel(c["points"], shape, rec_pixel),
                            dtype=torch.float32, device=dev)
        canvas = torch.zeros(shape, dtype=torch.float32, device=dev)
        lo = torch.floor(p)
        fr = p - lo
        lo = lo.to(torch.int64)
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    i = lo + torch.tensor([dz, dy, dx], device=dev)
                    w = ((fr[:, 0] if dz else 1 - fr[:, 0])
                         * (fr[:, 1] if dy else 1 - fr[:, 1])
                         * (fr[:, 2] if dx else 1 - fr[:, 2]))
                    ok = ((i >= 0) & (i < lim)).all(1)
                    lin = (i[:, 0] * ny + i[:, 1]) * nx + i[:, 2]
                    canvas.view(-1).index_add_(0, lin[ok], c["weight"] * w[ok])
        s = c["sigma"] / rec_pixel
        F += torch.fft.rfftn(canvas) * torch.exp(-2 * math.pi ** 2 * s * s * k2)
    return torch.fft.irfftn(F, s=shape)


def truth_tomogram(truth, shape, rec_pixel, device="cuda", classes=None):
    """The planted specimen rendered on the reconstruction grid."""
    if classes is None:
        classes, _, _ = make_truth(**_layout_kw(truth))
    return render(classes, shape, rec_pixel, device)


def particle_map(truth, box, rec_pixel, device="cuda"):
    """The planted particle (its canonical cloud, unrotated) in a box³ of
    `rec_pixel` Å voxels: the template of the template-matching run."""
    r = truth["particle_radius"]
    spread, sigma = _particle_shape(truth)
    return render({"particle": dict(points=particle_offsets(r, spread=spread),
                                    weight=1.0, sigma=sigma * r)},
                  (box, box, box), rec_pixel, device)


def _particle_shape(truth):
    """(spread, sigma) of the planted particle (truth files written before
    they were parameters hold the defaults)."""
    return (tuple(truth.get("particle_spread", (0.2, 0.45))),
            float(truth.get("particle_sigma", 0.45)))


def _layout_kw(truth):
    keys = ("size", "pixel", "axis_angle", "hand", "thickness",
            "particle_radius", "bead_radius")
    kw = {k: truth[k] for k in keys}
    a = truth["angles"]
    kw.update(tilt_min=a[0], tilt_max=a[-1],
              tilt_step=(a[1] - a[0]) if len(a) > 1 else 3.0,
              n_particles=len(truth["particles"]),
              virion_radii=tuple(v["radius"] for v in truth["virions"]),
              n_beads=len(truth["beads"]), height=truth["height"],
              layer=truth.get("layer"),
              seed=truth["seed"])
    kw["particle_spread"], kw["particle_sigma"] = _particle_shape(truth)
    return kw


def axis_error_deg(xf, truth):
    return float(abs(float(np.asarray(xf)[0, 2]) - truth["axis_angle"]))


def shift_errors_px(xf, truth, binning, sign=1.0):
    """Per-tilt |estimated - planted| aligning shift in binned px after
    removing the alignment's gauge freedom (the projection of one 3D
    translation, fitted by least squares). The estimate is sign x the
    shifts of `xf` (the bundle's `xf_shift_sign`)."""
    est = float(sign) * np.asarray(xf, np.float64)[:, :2]
    want = np.asarray(truth["shifts"], np.float64)
    th = np.radians(np.asarray(truth["angles"], np.float64))
    a = math.radians(float(np.asarray(xf)[0, 2]))
    ca, sa = math.cos(a), math.sin(a)
    # d(shift) = R(a) [ty, tx cos + tz sin]: columns ty, tx, tz
    A = np.zeros((len(th), 2, 3))
    A[:, 0, 0], A[:, 1, 0] = ca, -sa
    A[:, 0, 1], A[:, 1, 1] = sa * np.cos(th), ca * np.cos(th)
    A[:, 0, 2], A[:, 1, 2] = sa * np.sin(th), ca * np.sin(th)
    diff = (est - want).reshape(-1)
    t, *_ = np.linalg.lstsq(A.reshape(-1, 3), diff, rcond=None)
    resid = (diff - A.reshape(-1, 3) @ t).reshape(-1, 2)
    return np.hypot(resid[:, 0], resid[:, 1]) / binning


def defocus_rel_error(ctf, truth):
    fit = float(np.mean(np.asarray(ctf)[:, :2]))
    return abs(fit / float(np.mean(truth["defoci"])) - 1.0)


def best_offset(vol, ref, max_shift=8):
    """Integer 3D offset (dz, dy, dx) that best superposes `vol` on `ref`
    (both tensors), from their circular cross-correlation."""
    cc = torch.fft.irfftn(torch.fft.rfftn(vol) * torch.conj(torch.fft.rfftn(ref)),
                          s=vol.shape)
    idx = []
    for d, n in enumerate(vol.shape):
        r = torch.arange(n, device=vol.device)
        ok = (r <= max_shift) | (r >= n - max_shift)
        shape = [1, 1, 1]
        shape[d] = n
        cc = torch.where(ok.reshape(shape), cc, -torch.inf)
    flat = int(torch.argmax(cc))
    for n in reversed(vol.shape):
        idx.append(flat % n)
        flat //= n
    off = [i if i <= n // 2 else i - n for i, n in zip(reversed(idx), vol.shape)]
    return tuple(int(o) for o in off)


def slab_cc(vol, ref, offset=(0, 0, 0), half=16, lowpass_a=None, rec_pixel=1.0):
    """Correlation of the central z slab (+-half slices) of `vol` with
    `ref` moved by `offset`, optionally both low-passed to `lowpass_a`."""
    ref = torch.roll(ref, offset, (0, 1, 2))
    if lowpass_a:
        kz = torch.fft.fftfreq(vol.shape[0], device=vol.device)[:, None, None]
        ky = torch.fft.fftfreq(vol.shape[1], device=vol.device)[None, :, None]
        kx = torch.fft.rfftfreq(vol.shape[2], device=vol.device)[None, None, :]
        keep = (kz * kz + ky * ky + kx * kx) <= (rec_pixel / lowpass_a) ** 2
        vol = torch.fft.irfftn(torch.fft.rfftn(vol) * keep, s=vol.shape)
        ref = torch.fft.irfftn(torch.fft.rfftn(ref) * keep, s=ref.shape)
    c = vol.shape[0] // 2
    a = vol[c - half:c + half].reshape(-1)
    b = ref[c - half:c + half].reshape(-1)
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))


def recall(found, planted, tol):
    """Share of planted points (N, 3) with a found point within tol."""
    found = np.asarray(found, np.float64).reshape(-1, 3)
    planted = np.asarray(planted, np.float64).reshape(-1, 3)
    if not len(found) or not len(planted):
        return 0.0
    d = np.sqrt(((found[:, None] - planted[None]) ** 2).sum(-1))
    return float((d.min(axis=0) <= tol).mean())


def distance_to_segment(points, p0, p1):
    """Distance of points (N, 3) to the segment p0-p1."""
    p = np.asarray(points, np.float64).reshape(-1, 3)
    a, b = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    t = np.clip(((p - a) @ (b - a)) / max(float((b - a) @ (b - a)), 1e-12), 0, 1)
    return np.linalg.norm(p - (a + t[:, None] * (b - a)), axis=1)


def sheet_voxels(truth, shape, rec_pixel):
    """Boolean mask of the voxels within the planted sheet's width
    (|distance to the plane| <= sigma, inside its extent)."""
    s = truth["sheet"]
    nz, ny, nx = shape
    zz, yy, xx = np.meshgrid(*(np.arange(n) - n // 2 for n in shape),
                             indexing="ij")
    p = np.stack([zz, yy, xx], -1) * rec_pixel - np.asarray(s["centre"])
    dn = np.abs(p @ np.asarray(s["normal"]))
    du = np.abs(p @ np.asarray(s["u"]))
    dv = np.abs(p @ np.asarray(s["v"]))
    return (dn <= s["sigma"]) & (du <= s["half_u"]) & (dv <= s["half_v"])
