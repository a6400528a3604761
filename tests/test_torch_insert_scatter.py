"""The insertion's scatter (`ops.fourier_slice._scatter` through
`ops.kernels.insert_scatter`) and its hand-written CUDA kernel.

On the CPU: the wrapper gives, bit for bit, the chain as it was written
before the kernel (`old_scatter` below, kept as the oracle: the 8 corner
lists and three `index_add_` passes), for one set and two, with and
without set ids, and on Ewald-curved coordinates (both branches in one
call); its launch counter does not move; it refuses a wrong dtype, shape
or device; and the edge probes meet every decision the kernel has to
take as the chain takes it.

The `cuda`-marked tests hold the kernel against the plain version run on
the same card and skip where there is none: the benchmark's layout
(halves by particle) at box 32, `insert_slices` with one set, Ewald ±1
(and the ±2 unmixing) with both branches in one call, and the edge
probes (qx = ±0, the kx = nxf - 1 column and past it, the Nyquist
sphere's edge where the order of r^2's sum decides, and rows whose flip
would have sent corners to kx < 0). Their tolerance is 1e-5 of each
accumulator's largest magnitude, with the same zeros, because the kernel
and `index_add_` both add with atomics, whose order varies; every term
itself is the chain's bit for bit, which the case with a single term per
voxel holds to equality. They need no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_insert_scatter.py
"""

import numpy as np
import pytest
import torch

from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.ops import fourier_slice, kernels

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def old_scatter(q, vals, c2, pn, nxf, n_sets, set_id):
    """`_scatter` as it was written before the kernel."""
    flip = q[..., 2] < 0
    qs = torch.where(flip[..., None], -q, q)
    vals = torch.where(flip, vals.conj(), vals)
    q0f = torch.floor(qs)
    frac = qs - q0f
    q0 = q0f.to(torch.int64)
    in_sphere = torch.sum(q * q, dim=-1) <= (pn // 2) ** 2
    idx_all, wv_re, wv_im, wc2 = [], [], [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((frac[..., 0] if dz else 1 - frac[..., 0])
                     * (frac[..., 1] if dy else 1 - frac[..., 1])
                     * (frac[..., 2] if dx else 1 - frac[..., 2]))
                kz = q0[..., 0] + dz
                ky = q0[..., 1] + dy
                kx = q0[..., 2] + dx
                neg = kx < 0
                kzz = torch.where(neg, -kz, kz) % pn
                kyy = torch.where(neg, -ky, ky) % pn
                kxx = torch.where(neg, -kx, kx)
                valid = (kxx <= nxf - 1) & in_sphere
                kxx = torch.clamp(kxx, 0, nxf - 1)
                w = torch.where(valid, w, torch.zeros_like(w))
                v = torch.where(neg, vals.conj(), vals)
                idx_all.append(((kzz * pn + kyy) * nxf + kxx).reshape(-1))
                wv_re.append((w * v.real).reshape(-1))
                wv_im.append((w * v.imag).reshape(-1))
                wc2.append((w * c2).reshape(-1))
    idx, wre, wim, wc2 = (torch.cat(idx_all), torch.cat(wv_re),
                          torch.cat(wv_im), torch.cat(wc2))
    size = pn * pn * nxf
    if set_id is not None:
        per = idx.shape[0] // (8 * vals.shape[0])
        idx = idx + set_id.repeat_interleave(per).repeat(8) * size
    kw = dict(dtype=torch.float32, device=q.device)
    num_re = torch.zeros(n_sets * size, **kw).index_add_(0, idx, wre)
    num_im = torch.zeros(n_sets * size, **kw).index_add_(0, idx, wim)
    den = torch.zeros(n_sets * size, **kw).index_add_(0, idx, wc2)
    return (torch.complex(num_re, num_im).reshape(n_sets, pn, pn, nxf),
            den.reshape(n_sets, pn, pn, nxf))


def rotations(B, seed, dev="cpu"):
    rng = np.random.RandomState(seed)
    ang = rng.uniform(0.0, 360.0, (3, B)).astype(np.float32)
    return euler_to_matrix(*(torch.as_tensor(a, device=dev) for a in ang))


def samples(B, n, seed, dev="cpu"):
    """Random values and CTF^2 weights of B spectra (B, n, n//2+1)."""
    g = torch.Generator(dev).manual_seed(seed)
    shape = (B, n, n // 2 + 1)
    vals = torch.complex(torch.randn(shape, generator=g, device=dev),
                         torch.randn(shape, generator=g, device=dev))
    return vals, torch.rand(shape, generator=g, device=dev)


def scatter_case(name, dev="cpu", B=24, n=16, pad=2, seed=0):
    """(q, vals, c2, set_id, pn, nxf, n_sets) of one layout."""
    R = rotations(B, seed, dev)
    q = fourier_slice.slice_coords(R, n) * pad
    vals, c2 = samples(B, n, seed + 1, dev)
    halves = torch.arange(B, device=dev) % 2
    pn = pad * n
    if name == "one_set":
        return q, vals, c2, None, pn, pn // 2 + 1, 1
    if name == "two_sets_no_ids":
        return q, vals, c2, None, pn, pn // 2 + 1, 2
    if name == "halves":
        return q, vals, c2, halves, pn, pn // 2 + 1, 2
    # ewald: the curvature exaggerated so that the curved slices leave the
    # plane by voxels; both branches, each row carrying its particle's half
    curve = fourier_slice._ewald_curve(R, n, 0.05) * pad
    return (torch.cat([q + curve, -q + curve]),
            torch.cat([vals, vals.conj()]), torch.cat([c2, c2]),
            torch.cat([halves, halves]), pn, pn // 2 + 1, 2)


CPU_CASES = ("one_set", "two_sets_no_ids", "halves", "ewald")


@pytest.mark.parametrize("name", CPU_CASES)
def test_cpu_equals_the_old_chain(name):
    args = scatter_case(name)
    q, vals, c2, set_id, pn, nxf, n_sets = args
    launches = kernels.insert_scatter.launches
    num, den = kernels.insert_scatter(*args)
    num0, den0 = old_scatter(q, vals, c2, pn, nxf, n_sets, set_id)
    assert kernels.insert_scatter.launches == launches
    assert num.shape == (n_sets, pn, pn, nxf) and num.dtype == torch.complex64
    assert den.shape == (n_sets, pn, pn, nxf) and den.dtype == torch.float32
    assert torch.equal(num, num0) and torch.equal(den, den0)
    assert float(den.abs().sum()) > 0


def test_cpu_scatter_through_the_insertions():
    """`_scatter`'s callers on the CPU: insert_slices and
    insert_slices_halves give the old chain's accumulators."""
    B, n = 12, 16
    R = rotations(B, 5)
    F, ctfs = samples(B, n, 6)
    ctfs = ctfs - 0.5
    w = torch.rand(B, generator=torch.Generator().manual_seed(7))
    num, den = fourier_slice.insert_slices(F, ctfs, R, n, weights=w)
    q = fourier_slice.slice_coords(R, n) * 2
    w3 = w[:, None, None]
    num0, den0 = old_scatter(q, F * ctfs * w3, ctfs * ctfs * w3, 2 * n,
                             n + 1, 1, None)
    assert torch.equal(num, num0[0]) and torch.equal(den, den0[0])
    sub = torch.arange(B) % 2
    parts = fourier_slice.insert_slices_halves(F, ctfs, R, sub, w, n)
    num0, den0 = old_scatter(q, F * ctfs * w3, ctfs * ctfs * w3, 2 * n,
                             n + 1, 2, sub)
    for got, ref in zip(parts, (num0[0], den0[0], num0[1], den0[1])):
        assert torch.equal(got, ref)


def test_cpu_wrapper_refuses():
    q, vals, c2, set_id, pn, nxf, n_sets = scatter_case("halves", B=4, n=8)
    bad = [
        (TypeError, (q.double(), vals, c2, set_id)),
        (TypeError, (q, vals.to(torch.complex128), c2, set_id)),
        (TypeError, (q, vals, c2.double(), set_id)),
        (TypeError, (q, vals, c2, set_id.to(torch.int32))),
        (ValueError, (q[..., :2], vals, c2, set_id)),
        (ValueError, (q, vals, c2[:, :-1], set_id)),
        (ValueError, (q, vals[:, :-1], c2, set_id)),
        (ValueError, (q, vals, c2, set_id[:-1])),
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            kernels.insert_scatter(*args, pn, nxf, n_sets)
    with pytest.raises(ValueError):
        kernels.insert_scatter(q, vals, c2, set_id, pn, nxf, 0)
    with pytest.raises(ValueError):
        kernels.insert_scatter(q, vals, c2, set_id.to("meta"), pn, nxf, n_sets)


# ---------------------------------------------------------------------------
# the edge probes: each decision of the scatter, on coordinates made by hand

PN = 64                     # box 32 at pad 2
NXF = PN // 2 + 1
R_EDGE = PN // 2


def order_sensitive(count, seed):
    """Points near the Nyquist sphere (float32) where summing r^2 as
    (z^2 + x^2) + y^2 (torch.sum's order on a card) decides otherwise
    than another order: `count` inside that way, `count` outside."""
    rng = np.random.RandomState(seed)
    d = rng.randn(200_000, 3)
    p = (R_EDGE * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    sq = p * p
    a = (sq[:, 0] + sq[:, 2]) + sq[:, 1]
    b = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
    lim = np.float32(R_EDGE * R_EDGE)
    inside = np.where((a <= lim) & (b > lim))[0][:count]
    outside = np.where((a > lim) & (b <= lim))[0][:count]
    return np.concatenate([p[inside], p[outside]])


def edge_points():
    """(rows, per, 3) probe coordinates (qz, qy, qx) on the padded grid."""
    m = float(R_EDGE)
    hand = [
        # qx = +0 and -0 (no flip either way), off-grid in z and y
        (3.25, -7.5, 0.0), (3.25, -7.5, -0.0), (-0.0, 0.0, -0.0),
        (-12.7, 4.1, 0.0), (-12.7, 4.1, -0.0),
        # qx just below 0: the Friedel flip; the unflipped corners would
        # lie at kx = -1 and 0
        (5.5, 2.25, -1e-3), (-5.5, -2.25, -0.5), (20.1, -3.3, -0.999),
        (0.0, 0.0, -1e-7),
        # the kx = nxf - 1 column and past it: floor(qx) = 32 (corner 33
        # invalid), floor(qx) = 31 (corners 31, 32)
        (0.0, 0.0, m), (0.0, -0.0, -m), (0.5, -0.25, 31.9), (-1.25, 0.75, 31.5),
        # on the sphere exactly, and a last bit either side
        (m, 0.0, 0.0), (-m, 0.0, 0.0), (0.0, m, 0.0), (0.0, -m, 1e-6),
        (float(np.nextafter(np.float32(m), np.float32(0))), 0.0, 0.0),
        (float(np.nextafter(np.float32(m), np.float32(64))), 0.0, 0.0),
        # floor-mod in z and y at the box's wrap
        (-31.5, 31.5, 2.5), (31.99, -31.99, 0.01), (-0.5, -0.5, 0.5),
    ]
    pts = np.concatenate([np.asarray(hand, np.float32), order_sensitive(40, 0)])
    rows = 4
    pts = pts[: len(pts) // rows * rows]
    return torch.as_tensor(pts.reshape(rows, -1, 3))


def edge_case(dev="cpu"):
    q = edge_points().to(dev)
    g = torch.Generator(dev).manual_seed(2)
    shape = q.shape[:-1]
    vals = torch.complex(torch.randn(shape, generator=g, device=dev),
                         torch.randn(shape, generator=g, device=dev))
    c2 = torch.rand(shape, generator=g, device=dev)
    set_id = torch.arange(q.shape[0], device=dev) % 2
    return q, vals, c2, set_id, PN, NXF, 2


def test_edge_points_reach_every_decision():
    """The probes, on the plain version here, meet each rule the kernel has
    to decide as the chain does, and the chain equals the wrapper."""
    args = edge_case()
    q = args[0]
    qx = q[..., 2]
    sq = q * q
    r2 = (sq[..., 0] + sq[..., 2]) + sq[..., 1]     # torch.sum's on a card
    other = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    lim = float(R_EDGE ** 2)
    assert bool(((qx == 0) & torch.signbit(qx)).any())
    assert bool(((qx == 0) & ~torch.signbit(qx)).any())
    assert bool((qx < 0).any())
    assert bool((torch.floor(qx.abs()) == NXF - 1).any())
    assert bool((r2 == lim).any()) and bool((r2 > lim).any())
    # the order of the sum decides, both ways, among the probes
    assert bool(((r2 <= lim) & (other > lim)).any())
    assert bool(((r2 > lim) & (other <= lim)).any())
    num, den = kernels.insert_scatter(*args)
    num0, den0 = old_scatter(args[0], args[1], args[2], PN, NXF, 2, args[3])
    assert torch.equal(num, num0) and torch.equal(den, den0)


def single_term_case(dev="cpu"):
    """Points on a lattice of spacing 2 with fractions in (0, 1), all inside
    the sphere and at qx + 1 <= nxf - 1: each voxel receives at most one
    nonzero term, so the sums have no order to differ in."""
    rng = np.random.RandomState(4)
    lat = np.stack(np.meshgrid(np.arange(-7, 7), np.arange(-7, 7),
                               np.arange(0, 7), indexing="ij"), -1)
    lat = lat.reshape(-1, 3) * 2.0
    pts = lat + rng.uniform(0.05, 0.95, lat.shape)
    pts = pts[np.sum(pts * pts, -1) < 28.0 ** 2].astype(np.float32)
    rows = 2
    pts = pts[: len(pts) // rows * rows].reshape(rows, -1, 3)
    q = torch.as_tensor(pts, device=dev)
    g = torch.Generator(dev).manual_seed(3)
    shape = q.shape[:-1]
    vals = torch.complex(torch.randn(shape, generator=g, device=dev),
                         torch.randn(shape, generator=g, device=dev))
    c2 = torch.rand(shape, generator=g, device=dev)
    return q, vals, c2, torch.tensor([0, 1], device=dev), PN, NXF, 2


def test_single_term_lattice_has_one_term_a_voxel():
    """Each point's 8 corners are voxels that no other point reaches."""
    q, vals, c2, set_id, pn, nxf, n_sets = single_term_case()
    _, hits = kernels.insert_scatter(q, vals, torch.ones_like(c2), set_id,
                                     pn, nxf, n_sets)
    assert int((hits > 0).sum()) == 8 * q.shape[0] * q.shape[1]


# ---------------------------------------------------------------------------
# on a card


def _plain(monkeypatch):
    """Routes `_scatter` to the plain version for the reference side."""
    monkeypatch.setattr(kernels, "insert_scatter", lambda q, vals, c2, set_id,
                        pn, nxf, n_sets: kernels.insert_scatter_plain(
                            q, vals, c2, set_id, pn, nxf, n_sets))


def assert_close(got, ref):
    """Within 1e-5 of each accumulator's largest magnitude, with the same
    zeros: the kernel and index_add_ add in the order their atomics land."""
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a == 0, b == 0)
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def _insertion_inputs(B=41 * 16, n=32, seed=8):
    R = rotations(B, seed, "cuda")
    F, ctfs = samples(B, n, seed + 1, "cuda")
    ctfs = ctfs - 0.5
    w = torch.rand(B, generator=torch.Generator("cuda").manual_seed(seed),
                   device="cuda")
    return R, F, ctfs, w


@cuda
@needs_card
def test_cuda_csp_modes_layout(monkeypatch):
    """41 tilts x 16 particles at box 32, halves by particle, as the
    benchmark's accumulate_matrices inserts them."""
    R, F, ctfs, w = _insertion_inputs()
    sub = (torch.arange(R.shape[0], device="cuda") % 16) % 2
    launches = kernels.insert_scatter.launches
    got = fourier_slice.insert_slices_halves(F, ctfs, R, sub, w, 32)
    torch.cuda.synchronize()
    assert kernels.insert_scatter.launches == launches + 1
    _plain(monkeypatch)
    ref = fourier_slice.insert_slices_halves(F, ctfs, R, sub, w, 32)
    assert_close(got, ref)


@cuda
@needs_card
def test_cuda_insert_slices_one_set(monkeypatch):
    R, F, ctfs, w = _insertion_inputs(B=64, seed=9)
    got = fourier_slice.insert_slices(F, ctfs, R, 32, weights=w)
    _plain(monkeypatch)
    assert_close(got, fourier_slice.insert_slices(F, ctfs, R, 32, weights=w))


@cuda
@needs_card
@pytest.mark.parametrize("sign,unmix", [(1, False), (-1, False), (1, True)])
def test_cuda_ewald_both_branches(monkeypatch, sign, unmix):
    """IEWALD ±1: each particle inserts X(g) and X*(g) on the curved sphere
    in one call (2B slices); with `unmix`, ±2's reference-based branches."""
    R, F, ctfs, w = _insertion_inputs(B=48, seed=10)
    sub = torch.arange(R.shape[0], device="cuda") % 2
    kw = dict(ewald_c=sign * 0.02)
    if unmix:
        vol = torch.randn((32, 32, 32), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(11))
        kw.update(ref_fourier=fourier_slice.volume_to_fourier(vol),
                  chi=torch.rand(F.shape, device="cuda",
                                 generator=torch.Generator("cuda").manual_seed(12))
                  * 6.0)
    got = fourier_slice.insert_slices_halves(F, ctfs, R, sub, w, 32, **kw)
    _plain(monkeypatch)
    assert_close(got, fourier_slice.insert_slices_halves(F, ctfs, R, sub, w,
                                                         32, **kw))


@cuda
@needs_card
def test_cuda_edge_points():
    args = edge_case("cuda")
    num, den = kernels.insert_scatter(*args)
    assert_close((num, den), kernels.insert_scatter_plain(*args))


@cuda
@needs_card
def test_cuda_single_term_a_voxel_is_bit_equal():
    args = single_term_case("cuda")
    num, den = kernels.insert_scatter(*args)
    num0, den0 = kernels.insert_scatter_plain(*args)
    assert torch.equal(num, num0) and torch.equal(den, den0)
    assert int((den != 0).sum()) > 0


@cuda
@needs_card
def test_cuda_wrapper_refuses_and_counts():
    q, vals, c2, set_id, pn, nxf, n_sets = scatter_case("halves", "cuda", B=4,
                                                        n=8)
    with pytest.raises(ValueError):
        kernels.insert_scatter(q.transpose(0, 1), vals.transpose(0, 1),
                               c2.transpose(0, 1), None, pn, nxf, n_sets)
    with pytest.raises(ValueError):
        kernels.insert_scatter(q, vals, c2, set_id.cpu(), pn, nxf, n_sets)
    launches = kernels.insert_scatter.launches
    for args in (scatter_case(name, "cuda", B=4, n=8) for name in CPU_CASES):
        kernels.insert_scatter(*args)
    torch.cuda.synchronize()
    assert kernels.insert_scatter.launches == launches + len(CPU_CASES)
