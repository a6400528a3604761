"""pyp_tpu_torch.ops.kernels.shift_scored_match: the plain PyTorch version
(what the wrapper runs for CPU tensors) against the Pallas kernel in
interpret mode and its XLA scan, on the three cases of
tests/test_pallas_kernels.py and at that file's tolerances (scores rtol
2e-5 / atol 2e-4; shift indices may differ only on numerical ties, < 1%).

The `cuda`-marked tests hold the hand-written CUDA kernel against the
plain version on a card; they skip where there is none. They need no JAX
(the JAX package is imported inside the parity test only), so on a CUDA
machine without JAX they run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pyp_tpu_torch.ops import kernels

CASES = [dict(), dict(A=13, G=37, D=5, S=3, seed=1), dict(S=1, seed=2)]
# global-search shapes of the gather-engine slice: 256 particles x 72 psi
# rows, the 50-12 Å band at box 128 / 1 Å, 7.5° directions, +-6 px at 2 px
SLICE_CASE = dict(A=256 * 72, G=168, D=732, S=29, seed=3)


def make_problem(A=40, G=200, D=50, S=9, seed=0):
    """The inputs of tests/test_pallas_kernels.py's make_problem, as numpy."""
    rng = np.random.RandomState(seed)
    v = (rng.randn(A, G) + 1j * rng.randn(A, G)).astype(np.complex64)
    u = (rng.randn(G, D) + 1j * rng.randn(G, D)).astype(np.complex64)
    ph = rng.uniform(0, 2 * np.pi, (G, S)).astype(np.float32)
    E = np.exp(1j * ph).astype(np.complex64)
    ninv = (1.0 / (1.0 + rng.rand(A, D))).astype(np.float32)
    return v, u, E, ninv


def torch_inputs(args, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in args]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_plain_matches_jax(case, reference):
    import jax.numpy as jnp

    from pyp_tpu.ops import pallas_kernels as pk

    args = make_problem(**CASES[case])
    jargs = [jnp.asarray(a) for a in args]
    if reference == "xla":
        ref_score, ref_idx = pk.shift_scored_match_xla(*jargs)
    else:
        ref_score, ref_idx = pk.shift_scored_match(*jargs, interpret=True)
    launches = kernels.shift_scored_match.launches
    score, idx = kernels.shift_scored_match(*torch_inputs(args))
    assert kernels.shift_scored_match.launches == launches  # CPU: no kernel
    assert score.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_score),
                               rtol=2e-5, atol=2e-4)
    assert (idx.numpy() != np.asarray(ref_idx)).mean() < 0.01
    if CASES[case].get("S") == 1:
        assert np.all(idx.numpy() == 0)


def test_wrapper_validates_inputs():
    v, u, E, ninv = torch_inputs(make_problem(A=8, G=16, D=4, S=2))
    with pytest.raises(ValueError, match="do not agree"):
        kernels.shift_scored_match(v, u[:-1], E, ninv)
    with pytest.raises(TypeError, match="complex64"):
        kernels.shift_scored_match(v.to(torch.complex128), u, E, ninv)


# the string condition is evaluated when the test runs, not at import
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("case", CASES + [SLICE_CASE])
def test_cuda_kernel_matches_plain(case):
    args = torch_inputs(make_problem(**case), "cuda")
    launches = kernels.shift_scored_match.launches
    score, idx = kernels.shift_scored_match(*args)
    ref_score, ref_idx = kernels.shift_scored_match_plain(*args)
    torch.cuda.synchronize()
    assert kernels.shift_scored_match.launches == launches + 1
    scale = float(ref_score.abs().max())
    torch.testing.assert_close(score, ref_score, rtol=2e-5, atol=2e-4 * scale)
    assert (idx != ref_idx).float().mean().item() < 0.01
