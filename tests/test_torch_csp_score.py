"""CSP's CTF-weighted NCC (`ops.csp._csp_ncc` through
`ops.kernels.csp_score`) and its hand-written CUDA kernels.

On the CPU: the score and its gradient with respect to each mode's blocks
equal, bit for bit, the chain as it was written before the kernels
(`old_ncc` below, kept as the oracle), with the mode's reused reference
slice values and CTF as the refinement reuses them, padded rows, and a
leading candidate axis with the window samples and slice values repeating
under it; the backward kernel's closed form (`csp_score_grad_plain`)
equals autograd through the plain chain in float64 to 1e-10 relative L2,
with respect to dshift, df and u and, through them, every mode's blocks
(shifts through dshift; tilt and axis through dshift, df and u; eulers
through u; positions through dshift and df; defocus offsets through df);
the wrapper refuses a wrong dtype, shape or device and window samples or
mask points that require grad.

The `cuda`-marked tests hold the kernels against the plain chain in
float64 on a card and skip where there is none, at the shapes they serve:
the benchmark's (8 x 41 x 128 rows, 390 points), one series at box 256
(thousands of points), a grid-search batch (a leading candidate axis, the
windows and slice values read once for every candidate) and an odd point
count: forward max abs error <= 1e-5, gradients relative L2 <= 1e-4, and
neither more than twice the float32 plain chain's own; the gradients
without u's equal those with it; the launch counters. They need no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_csp_score.py
"""

import math

import numpy as np
import pytest
import torch

from pyp_tpu_torch.ops import csp, kernels, refine3d
from pyp_tpu_torch.ops.fourier_slice import volume_to_fourier

KW = dict(voltage_kv=300.0, cs_mm=2.7, amplitude_contrast=0.07)
BLOCK_ROUTES = {     # the block a mode moves, and what it moves the score by
    0: "dshift, df, u", 1: "u", 2: "dshift, df", 3: "dshift", 4: "df",
    5: "dshift", 6: "dshift, df", 7: "u"}
CASES = [(mode, lead) for mode in range(8) for lead in (False, True)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def old_ctf(params, tilt_defocus, mask_pts, n, pixel_size, voltage_kv, cs_mm,
            amplitude_contrast):
    """The (..., T, P, G) CTF as `ops.csp._csp_ctf` computed it."""
    depth = csp.particle_depth(params)
    df = (tilt_defocus[..., :, None, 0] + params.defocus_offsets[..., :, None]
          + depth * pixel_size)
    return refine3d._ctf_at_points(mask_pts, n, pixel_size, df[..., None],
                                   df[..., None], 0.0, voltage_kv, cs_mm,
                                   amplitude_contrast, 0.0)


def old_ncc(params, xv, window_centers, tilt_defocus, mask_pts, Fref, n,
            pixel_size, voltage_kv, cs_mm, amplitude_contrast, u=None,
            c=None):
    """`ops.csp._csp_ncc` as it was written before the kernels."""
    dshift = csp.project_positions(params) - window_centers
    if u is None:
        u = csp._csp_model_gather(params, mask_pts, Fref, n)
    if c is None:
        c = old_ctf(params, tilt_defocus, mask_pts, n, pixel_size,
                    voltage_kv, cs_mm, amplitude_contrast)
    ph = (-2.0 * math.pi / n) * (mask_pts[:, 0] * dshift[..., 0:1]
                                 + mask_pts[:, 1] * dshift[..., 1:2])
    xr, xi, ur, ui = xv.real, xv.imag, u.real, u.imag
    re_xu = xr * ur + xi * ui
    im_xu = xr * ui - xi * ur
    num = torch.sum(c * (re_xu * torch.cos(ph) - im_xu * torch.sin(ph)), -1)
    den = torch.sqrt(torch.sum(xr * xr + xi * xi, -1)
                     * torch.sum(c * c * (ur * ur + ui * ui), -1) + 1e-12)
    return num / den


def problem(mode, lead, dtype=torch.float32, dev="cpu", S=2, T=5, P=6, n=24,
            pixel=2.0, band=(60.0, 5.0), K=3, seed=0):
    """(params, xv, centres, tilt defocus, mask points, Fref, weights W)
    of S series with every validity 1 but two padded rows (zero windows,
    zero weight); with `lead`, K candidates of the mode's block on a
    leading axis, as the grid search offsets them. The candidates' start
    is returned too (the point where u0 and df0 are taken)."""
    rng = np.random.RandomState(seed)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64

    def real(*shape, lo=-1.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=dtype,
                               device=dev)

    start = csp.CspParams(
        torch.as_tensor(np.tile(np.linspace(-60, 60, T), (S, 1)),
                        dtype=dtype, device=dev) + real(S, T),
        85.0 + real(S, T), real(S, T, 2, lo=-3, hi=3),
        real(S, P, 3, lo=0, hi=360), real(S, P, 3, lo=-40, hi=40),
        real(S, T, lo=-300, hi=300))
    params = start
    if lead:
        d = {0: 2, 3: 2, 5: 2, 4: 1}.get(mode, 3)
        off = torch.as_tensor(csp.make_mode_offsets(mode, 2.0, 5)[:K],
                              dtype=dtype, device=dev)
        params = csp._apply_mode_offset(start, mode,
                                        off.reshape(len(off), 1, 1, d))
    mask = torch.as_tensor(refine3d.make_mask_points(n, pixel, *band),
                           dtype=dtype, device=dev)
    G = mask.shape[0]
    Fref = volume_to_fourier(torch.as_tensor(rng.randn(n, n, n), dtype=dtype,
                                             device=dev)).to(cdt)
    xv = torch.complex(real(S, T, P, G), real(S, T, P, G))
    xv[0, 1, -1] = 0                                # padded rows
    xv[-1, -1, 0] = 0
    centres = torch.round(csp.project_positions(start)) + real(S, T, P, 2,
                                                                lo=-1, hi=1)
    tdf = torch.full((S, T, 2), 15000.0, dtype=dtype, device=dev) + real(
        S, T, 1, lo=-2000, hi=2000)
    lead_shape = torch.broadcast_shapes(
        csp.project_positions(params).shape[:-1],
        csp.effective_rotations(params).shape[:-2],
        csp._csp_df(params, tdf, pixel).shape)
    W = real(*lead_shape)
    W[..., 0, 1, -1] = 0
    W[..., -1, -1, 0] = 0
    return params, start, xv, centres.detach(), tdf, mask, Fref, W


def reused(mode, start, tdf, mask, Fref, n, pixel):
    """(u0, c0, df0) as the refinement reuses them for `mode`."""
    with torch.no_grad():
        u0 = (csp._csp_model_gather(start, mask, Fref, n)
              if mode in csp.SHIFT_MODES else None)
        c0 = (old_ctf(start, tdf, mask, n, pixel, **KW)
              if mode in csp.CTF_CONST_MODES else None)
        df0 = (csp._csp_df(start, tdf, pixel)
               if mode in csp.CTF_CONST_MODES else None)
    return u0, c0, df0


def block_grads(fn, params, mode, W):
    blocks = csp.MODE_BLOCKS[mode]
    leaves = {k: getattr(params, k).detach().requires_grad_(True)
              for k in blocks}
    ncc = fn(params._replace(**leaves))
    return ncc.detach(), torch.autograd.grad(torch.sum(W * ncc),
                                             list(leaves.values()))


def rel_l2(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("mode,lead", CASES)
def test_plain_equals_the_old_chain(mode, lead):
    n, pixel = 24, 2.0
    params, start, xv, wc, tdf, mask, Fref, W = problem(mode, lead)
    u0, c0, df0 = reused(mode, start, tdf, mask, Fref, n, pixel)
    got, g = block_grads(lambda p: csp._csp_ncc(
        p, xv, wc, tdf, mask, Fref, n, pixel, **KW, u=u0, df=df0),
        params, mode, W)
    want, g0 = block_grads(lambda p: old_ncc(
        p, xv, wc, tdf, mask, Fref, n, pixel, **KW, u=u0, c=c0),
        params, mode, W)
    assert got.shape == W.shape and bool(got.abs().gt(0.01).any())
    assert torch.equal(got, want)
    for a, b in zip(g, g0):
        assert bool(b.ne(0).any()) and torch.equal(a, b)
    # and the whole chain, nothing reused, as the scores are taken
    s = csp._csp_ncc(params, xv, wc, tdf, mask, Fref, n, pixel, **KW)
    assert torch.equal(s, old_ncc(params, xv, wc, tdf, mask, Fref, n, pixel,
                                  **KW))


def _score_inputs(params, xv, wc, tdf, mask, Fref, n, pixel):
    return (csp.project_positions(params) - wc, csp._csp_df(params, tdf, pixel),
            csp._csp_model_gather(params, mask, Fref, n))


@pytest.mark.parametrize("mode,lead", CASES)
def test_closed_form_gradient_equals_autograd(mode, lead):
    """In float64: the closed form against autograd through the plain
    chain, with respect to dshift, df and u themselves, and through them
    with respect to the mode's blocks."""
    n, pixel = 24, 2.0
    params, start, xv, wc, tdf, mask, Fref, W = problem(
        mode, lead, dtype=torch.float64)
    blocks = csp.MODE_BLOCKS[mode]
    leaves = {k: getattr(params, k).detach().requires_grad_(True)
              for k in blocks}
    p = params._replace(**leaves)
    # as the grid search takes them: the shift modes' slice values at the
    # start, read again by every candidate, as the windows are
    ins = _score_inputs(p, xv, wc, tdf, mask, Fref, n, pixel)
    if mode in csp.SHIFT_MODES:
        ins = ins[:2] + (csp._csp_model_gather(start, mask, Fref, n),)
    direct = [x.detach().requires_grad_(True) for x in ins]
    ncc = kernels.csp_score_plain(*direct[:2], xv, direct[2], mask, n, pixel,
                                  **KW)
    want = torch.autograd.grad(torch.sum(W * ncc), direct)
    got = kernels.csp_score_grad_plain(*(x.detach() for x in ins[:2]), xv,
                                       ins[2].detach(), mask, n, pixel, **KW,
                                       grad=W)
    for a, b, x in zip(got, want, ins):
        assert a.shape == x.shape and rel_l2(a, b) <= 1e-10
    # through dshift, df and u onto the blocks, the routes BLOCK_ROUTES names
    used = [(x, gx) for x, gx, name in zip(ins, got, ("dshift", "df", "u"))
            if x.requires_grad]
    assert {name for x, name in zip(ins, ("dshift", "df", "u"))
            if x.requires_grad} == set(BLOCK_ROUTES[mode].split(", "))
    got_b = torch.autograd.grad([x for x, _ in used], list(leaves.values()),
                                [gx for _, gx in used], retain_graph=True)
    ncc_b = kernels.csp_score_plain(*ins[:2], xv, ins[2], mask, n, pixel,
                                    **KW)
    want_b = torch.autograd.grad(torch.sum(W * ncc_b), list(leaves.values()))
    for a, b in zip(got_b, want_b):
        assert bool(b.ne(0).any()) and rel_l2(a, b) <= 1e-10


def _refusal_inputs():
    params, _, xv, wc, tdf, mask, Fref, _ = problem(1, False, S=1, T=3, P=2,
                                                     n=16)
    dshift, df, u = (x.detach() for x in _score_inputs(
        params, xv, wc, tdf, mask, Fref, 16, 2.0))
    return dict(dshift=dshift, df=df, xv=xv, u=u, mask_pts=mask)


REFUSALS = [
    ("dtype", TypeError, lambda a: {**a, "df": a["df"].double()}),
    ("dtype", TypeError, lambda a: {**a, "u": a["u"].to(torch.complex128)}),
    ("dtype", TypeError, lambda a: {**a, "xv": a["xv"].real.contiguous()}),
    ("shape", ValueError, lambda a: {**a, "u": a["u"][..., :-1]}),
    ("shape", ValueError, lambda a: {**a, "dshift": a["dshift"][..., :1]}),
    ("shape", ValueError, lambda a: {**a, "mask_pts": a["mask_pts"].T}),
    ("shape", ValueError, lambda a: {**a, "df": a["df"][..., :1, :].repeat(
        1, 1, 3)}),
    ("device", ValueError, lambda a: {**a, "u": a["u"].to("meta")}),
    ("grad", ValueError, lambda a: {
        **a, "mask_pts": a["mask_pts"].clone().requires_grad_(True)}),
    ("grad", ValueError, lambda a: {
        **a, "xv": a["xv"].clone().requires_grad_(True)}),
]


@pytest.mark.parametrize("what,error,change", REFUSALS,
                         ids=[f"{r[0]}{i}" for i, r in enumerate(REFUSALS)])
def test_wrapper_refuses(what, error, change):
    a = _refusal_inputs()
    kernels.csp_score(**a, n=16, pixel_size=2.0, **KW)      # as they are
    with pytest.raises(error):
        kernels.csp_score(**change(a), n=16, pixel_size=2.0, **KW)


# ---------------------------------------------------------------------------
# on a card

def _cuda_case(name):
    """(dshift, df, xv, u, mask, n, pixel) on the card for one shape the
    kernels serve, float32, dshift, df and u requiring grad."""
    g = torch.Generator("cuda").manual_seed(11)
    if name == "csp_modes":
        lead, n, pixel, band = (8, 41, 128), 64, 2.0, (60.0, 8.0)
    elif name == "box256":
        lead, n, pixel, band = (41, 64), 256, 2.0, (60.0, 8.0)
    elif name == "grid":
        lead, n, pixel, band = (2, 41, 128), 64, 2.0, (60.0, 8.0)
    else:                                           # an odd point count
        lead, n, pixel, band = (3, 41, 20), 32, 2.0, (60.0, 8.0)
    mask = torch.as_tensor(refine3d.make_mask_points(n, pixel, *band),
                           device="cuda")
    if name == "odd":
        mask = mask[:-1] if mask.shape[0] % 2 == 0 else mask
    G = mask.shape[0]

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    K = 9 if name == "grid" else 1
    dshift = randn(*((K,) if K > 1 else ()), *lead, 2, scale=1.5)
    df = 15000.0 + randn(*lead, scale=3000.0)
    xv = torch.complex(randn(*lead, G), randn(*lead, G))
    u = torch.complex(randn(*lead, G), randn(*lead, G)) * 3.0
    return dshift, df, xv, u, mask, n, pixel


def _card_grads(fn, dshift, df, xv, u, W):
    ins = [x.detach().clone().requires_grad_(True) for x in (dshift, df, u)]
    ncc = fn(ins[0], ins[1], xv, ins[2])
    return ncc.detach(), torch.autograd.grad(torch.sum(W * ncc), ins)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("name", ["csp_modes", "box256", "grid", "odd"])
def test_cuda_kernels_match_plain(name):
    dshift, df, xv, u, mask, n, pixel = _cuda_case(name)
    lead = torch.broadcast_shapes(dshift.shape[:-1], df.shape)
    W = torch.rand(lead, generator=torch.Generator("cuda").manual_seed(5),
                   device="cuda")

    def run(fn, dt=None):
        ds, d, x, uu, m = dshift, df, xv, u, mask
        if dt is not None:
            cdt = torch.complex128
            ds, d, m = ds.to(dt), d.to(dt), m.to(dt)
            x, uu = x.to(cdt), uu.to(cdt)
        return _card_grads(lambda a, b, c, e: fn(a, b, c, e, m, n, pixel,
                                                 **KW), ds, d, x, uu,
                           W.to(dt or W.dtype))

    f0 = kernels.csp_score.launches
    b0 = kernels.csp_score.backward_launches
    got, g = run(kernels.csp_score)
    torch.cuda.synchronize()
    assert kernels.csp_score.launches == f0 + 1
    assert kernels.csp_score.backward_launches == b0 + 1
    ref, g_ref = run(kernels.csp_score_plain, torch.float64)
    p32, g_p32 = run(kernels.csp_score_plain)
    err = float((got.double() - ref).abs().max())
    err32 = float((p32.double() - ref).abs().max())
    assert err <= 1e-5 and err <= 2 * err32, (err, err32)
    for a, b, c in zip(g, g_ref, g_p32):
        e, e32 = rel_l2(a.to(b.dtype), b), rel_l2(c.to(b.dtype), b)
        assert e <= 1e-4 and e <= 2 * e32, (e, e32)
    # without u's gradient the kernel writes no du; the others are the same
    ds = dshift.detach().clone().requires_grad_(True)
    d = df.detach().clone().requires_grad_(True)
    ncc = kernels.csp_score(ds, d, xv, u, mask, n, pixel, **KW)
    g2 = torch.autograd.grad(torch.sum(W * ncc), [ds, d])
    assert torch.equal(ncc, got)
    assert torch.equal(g2[0], g[0]) and torch.equal(g2[1], g[1])


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_wrapper_refuses_and_takes_no_plain_path(monkeypatch):
    a = {k: (v.cuda() if v.device.type == "cpu" else v)
         for k, v in _refusal_inputs().items()}
    with pytest.raises(ValueError):
        kernels.csp_score(**{**a, "u": a["u"].cpu()}, n=16, pixel_size=2.0,
                          **KW)
    with pytest.raises(TypeError):
        kernels.csp_score(**{**a, "df": a["df"].double()}, n=16,
                          pixel_size=2.0, **KW)

    def refuse(*args, **kw):
        raise AssertionError("the plain chain ran on the card")

    monkeypatch.setattr(kernels, "csp_score_plain", refuse)
    f0 = kernels.csp_score.launches
    with torch.no_grad():
        kernels.csp_score(**a, n=16, pixel_size=2.0, **KW)
    torch.cuda.synchronize()
    assert kernels.csp_score.launches == f0 + 1
