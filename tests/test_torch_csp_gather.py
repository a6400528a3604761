"""The CSP model gather (`ops.csp._csp_model_gather` through
`ops.kernels.csp_slice_gather`) and its hand-written CUDA kernel.

On the CPU: the gather equals the plain composition (effective_rotations,
the slice points, gather_3d_hermitian) bit for bit, and so does its
gradient with respect to the mode's blocks (tilt and axis angles in mode
0, eulers in mode 1), with and without a leading candidate axis; and the
backward kernel's arithmetic (`csp_slice_gather_grad_plain`: through the
trilinear weights, the Friedel flip's sign and the scale) gives
autograd's gradient with respect to the rotations within 1e-5 relative
L2 (float32 sums in another order).

The `cuda`-marked tests hold the kernel against the plain version on a
card and skip where there is none: forward max abs error <= 1e-5 x
max|u|, the same zeros (the Nyquist and validity decisions), backward
relative L2 <= 1e-4 against autograd through the plain version; points
on and just off the Nyquist sphere, on qx = 0 (either sign of zero), at
kx = nxf - 1 and past it, and at qx < 0, where the Friedel mate is read
(after the flip no corner lies at kx < 0); the wrapper's refusals and
its launch counters. They need no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py tests/test_torch_cuda.py \
        tests/test_torch_csp_gather.py
"""

import numpy as np
import pytest
import torch

from pyp_tpu_torch.ops import csp, kernels
from pyp_tpu_torch.ops.fourier_slice import gather_3d_hermitian, volume_to_fourier
from pyp_tpu_torch.ops.refine3d import make_mask_points

BLOCKS = {0: ("tilt_angles", "axis_angles"), 1: ("particle_eulers",)}
CASES = [(mode, lead) for mode in (0, 1) for lead in (False, True)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def problem(mode, lead, dev="cpu", S=2, T=5, P=6, n=24, K=3, seed=0):
    """(params, mask points, Fref, n, upstream gradient W) of S series; with
    `lead`, K candidates of the mode's block on a leading axis, as the grid
    search offsets them."""
    rng = np.random.RandomState(seed)

    def f32(*shape, lo=-1.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32),
                               device=dev)

    params = csp.CspParams(
        torch.as_tensor(np.tile(np.linspace(-60, 60, T, dtype=np.float32),
                                (S, 1)), device=dev) + f32(S, T),
        85.0 + f32(S, T), f32(S, T, 2, lo=-3, hi=3),
        f32(S, P, 3, lo=0, hi=360), f32(S, P, 3, lo=-50, hi=50),
        torch.zeros((S, T), device=dev))
    if lead:
        d = 2 if mode == 0 else 3
        off = torch.as_tensor(csp.make_mode_offsets(mode, 2.0, 5)[:K], device=dev)
        params = csp._apply_mode_offset(params, mode,
                                        off.reshape(len(off), 1, 1, d))
    mask = torch.as_tensor(make_mask_points(n, 2.0, 60.0, 5.0), device=dev)
    vol = torch.as_tensor(rng.randn(n, n, n).astype(np.float32), device=dev)
    Fref = volume_to_fourier(vol)
    shape = csp.effective_rotations(params).shape[:-2] + (mask.shape[0],)
    W = torch.complex(f32(*shape), f32(*shape))
    return params, mask, Fref, n, W


def composition(params, mask, Fref, n):
    """The plain chain the kernel replaces, written out."""
    R = csp.effective_rotations(params)
    q = (mask[:, 1, None] * R[..., None, 0, :]
         + mask[:, 0, None] * R[..., None, 1, :])
    return gather_3d_hermitian(Fref, q.flip(-1), scale=float(Fref.shape[0] // n))


def block_grads(fn, params, mode, W):
    leaves = {k: getattr(params, k).detach().requires_grad_(True)
              for k in BLOCKS[mode]}
    u = fn(params._replace(**leaves))
    loss = torch.sum(W.real * u.real + W.imag * u.imag)   # Re(conj(W) u)
    return u.detach(), torch.autograd.grad(loss, list(leaves.values()))


def rel_l2(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("mode,lead", CASES)
def test_gather_equals_the_composition(mode, lead):
    params, mask, Fref, n, W = problem(mode, lead)
    u, g = block_grads(lambda p: csp._csp_model_gather(p, mask, Fref, n),
                       params, mode, W)
    u0, g0 = block_grads(lambda p: composition(p, mask, Fref, n),
                         params, mode, W)
    assert u.shape == W.shape and bool((u != 0).any())
    assert torch.equal(u, u0)
    for a, b in zip(g, g0):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode,lead", CASES)
def test_backward_arithmetic_matches_autograd(mode, lead):
    params, mask, Fref, n, W = problem(mode, lead)
    scale = float(Fref.shape[0] // n)
    R = (csp.effective_rotations(params).reshape(-1, 3, 3)
         .detach().requires_grad_(True))
    u = kernels.csp_slice_gather_plain(R, mask, Fref, scale)
    want, = torch.autograd.grad(u, R, W.reshape(u.shape))
    got = kernels.csp_slice_gather_grad_plain(R.detach(), mask, Fref, scale,
                                              W.reshape(u.shape))
    assert got.shape == R.shape and not bool(got[:, 2].any())
    assert rel_l2(got, want) <= 1e-5


def edge_problem(dev, n=32, seed=7):
    """Rotations and mask points placed on the gather's decisions at box n,
    pad 2 (m = 2n, nxf = n + 1): (R (rows, 3, 3), mask (G, 2), Fref)."""
    rng = np.random.RandomState(seed)
    h = n / 2                                   # the sphere's radius, unscaled
    th = rng.uniform(0, 2 * np.pi, 64)
    pts = [(0.0, h), (0.0, h + 2.0**-18), (0.0, h - 0.25), (0.0, h - 2.0**-18),
           (3.0, 0.0), (-3.0, 0.0), (3.0, -0.25), (-2.5, -1e-6), (5.5, 7.25),
           (-11.3, -9.7), (12.0, 11.3), (0.0, -h), (-h, 0.0)]
    pts += list(zip(h * np.sin(th), h * np.cos(th)))        # on the sphere
    pts += list(zip(rng.uniform(-h, h, 64), rng.uniform(-h, h, 64)))
    mask = np.asarray(pts, np.float32)
    Rs = [np.eye(3), [[0, 1, 0], [-1, 0, 0], [0, 0, 1]],    # qx = -ky
          [[0.0, 1, 0], [-0.0, 0, 1], [1, 0, 0]],          # qx = +-0
          [[-1, 0, 0], [0, -1, 0], [0, 0, 1]]]
    for a, b, c in rng.uniform(0, 2 * np.pi, (8, 3)):
        rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                       [0, 0, 1]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                       [-np.sin(b), 0, np.cos(b)]])
        rz2 = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0],
                        [0, 0, 1]])
        Rs.append(rz @ ry @ rz2)
    R = torch.as_tensor(np.asarray(Rs, np.float32), device=dev)
    m = 2 * n
    Fref = torch.complex(*(torch.as_tensor(
        rng.randn(m, m, m // 2 + 1).astype(np.float32), device=dev)
        for _ in range(2)))
    return R, torch.as_tensor(mask, device=dev), Fref


def test_edge_points_reach_every_decision():
    """The edge set, on the plain version here, meets each rule the
    kernel has to decide as the plain chain does."""
    R, mask, Fref = edge_problem("cpu")
    q = 2.0 * (mask[:, 1, None] * R[:, None, 0, :]
               + mask[:, 0, None] * R[:, None, 1, :])
    r2 = (q * q).flip(-1).sum(-1)       # summed as the gather sums, z first
    u = kernels.csp_slice_gather_plain(R, mask, Fref, 2.0)
    assert bool((r2 == 32.0**2).any()) and bool((r2 > 32.0**2).any())
    assert bool((q[..., 0] < 0).any()) and bool((q[..., 0] == 0).any())
    assert bool((torch.signbit(q[..., 0]) & (q[..., 0] == 0)).any())
    assert bool((torch.floor(q[..., 0].abs()) == 32).any())   # kx = nxf - 1
    assert bool((u[r2 > 32.0**2] == 0).all())


# ---------------------------------------------------------------------------
# on a card


def _cuda_problem(mode, lead):
    return problem(mode, lead, dev="cuda", S=2, T=41, P=32, n=32, K=5, seed=3)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("mode,lead", CASES)
def test_cuda_kernel_matches_plain(mode, lead):
    params, mask, Fref, n, W = _cuda_problem(mode, lead)
    f0, b0 = kernels.csp_slice_gather.launches, kernels.csp_slice_gather.backward_launches
    u, g = block_grads(lambda p: csp._csp_model_gather(p, mask, Fref, n),
                       params, mode, W)
    scale = float(Fref.shape[0] // n)
    u0, g0 = block_grads(lambda p: kernels.csp_slice_gather_plain(
        csp.effective_rotations(p), mask, Fref, scale), params, mode, W)
    torch.cuda.synchronize()
    assert kernels.csp_slice_gather.launches == f0 + 1
    assert kernels.csp_slice_gather.backward_launches == b0 + 1
    assert torch.equal(u == 0, u0 == 0)
    assert float((u - u0).abs().max()) <= 1e-5 * float(u0.abs().max())
    for a, b in zip(g, g0):
        assert rel_l2(a, b) <= 1e-4


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_kernel_edge_points():
    R, mask, Fref = edge_problem("cuda")
    W = torch.complex(*(torch.randn((R.shape[0], mask.shape[0]), device="cuda",
                                    generator=torch.Generator("cuda").manual_seed(s))
                        for s in (1, 2)))
    Rk = R.clone().requires_grad_(True)
    Rp = R.clone().requires_grad_(True)
    u = kernels.csp_slice_gather(Rk, mask, Fref, 2.0)
    u0 = kernels.csp_slice_gather_plain(Rp, mask, Fref, 2.0)
    gk, = torch.autograd.grad(u, Rk, W)
    gp, = torch.autograd.grad(u0, Rp, W)
    u, u0 = u.detach(), u0.detach()
    torch.cuda.synchronize()
    assert torch.equal(u == 0, u0 == 0)
    assert float((u - u0).abs().max()) <= 1e-5 * float(u0.abs().max())
    assert rel_l2(gk, gp) <= 1e-4


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_wrapper_refuses_and_counts():
    R, mask, Fref = edge_problem("cuda", n=16)
    with pytest.raises(TypeError):
        kernels.csp_slice_gather(R, mask, Fref.to(torch.complex128), 2.0)
    with pytest.raises(ValueError):
        kernels.csp_slice_gather(R, mask, Fref.transpose(0, 1), 2.0)
    with pytest.raises(ValueError):
        kernels.csp_slice_gather(R, mask, Fref.clone().requires_grad_(True), 2.0)
    with pytest.raises(ValueError):
        kernels.csp_slice_gather(R, mask.cpu(), Fref, 2.0)
    f0 = kernels.csp_slice_gather.launches
    b0 = kernels.csp_slice_gather.backward_launches
    with torch.no_grad():
        kernels.csp_slice_gather(R, mask, Fref, 2.0)
    Rg = R.clone().requires_grad_(True)
    kernels.csp_slice_gather(Rg, mask, Fref, 2.0).abs().sum().backward()
    torch.cuda.synchronize()
    assert kernels.csp_slice_gather.launches == f0 + 2
    assert kernels.csp_slice_gather.backward_launches == b0 + 1
