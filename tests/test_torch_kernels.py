"""pyp_tpu_torch.ops.kernels.shift_scored_match: the plain PyTorch version
(what the wrapper runs for CPU tensors) against the Pallas kernel in
interpret mode and its XLA scan, on the three cases of
tests/test_pallas_kernels.py and the kernel's own (S > 32, ragged G and D),
at that file's tolerances (scores rtol 2e-5 / atol 2e-4; shift indices
may differ only on numerical ties, < 1%).

The operands the wrapper lays out for the tensor-core kernel
(`kernel_operands`: TF32 hi/lo splits cut into tile images) are checked on
the CPU by reading the images back and doing the kernel's 3xTF32
arithmetic on them, against the plain version at the same tolerances.

The `cuda`-marked tests hold the hand-written CUDA kernel against the
plain version on a card; they skip where there is none. They need no JAX
(the JAX package is imported inside the parity test only), so on a CUDA
machine without JAX they run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py tests/test_torch_cuda.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pyp_tpu_torch.ops import kernels

CASES = [dict(), dict(A=13, G=37, D=5, S=3, seed=1), dict(S=1, seed=2)]
# S > 32 runs as two chunks of 25 shifts; G % 4 != 0 and D % 8 != 0 leave
# ragged K and direction tiles
KERNEL_CASES = [dict(A=300, G=64, D=40, S=49, seed=4),
                dict(A=1000, G=37, D=13, S=7, seed=5)]
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


@pytest.mark.parametrize("case", range(len(CASES + KERNEL_CASES)))
@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_plain_matches_jax(case, reference):
    import jax.numpy as jnp

    from pyp_tpu.ops import pallas_kernels as pk

    case = (CASES + KERNEL_CASES)[case]
    args = make_problem(**case)
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
    if case.get("S") == 1:
        assert np.all(idx.numpy() == 0)


def emulate_kernel(v, u, E, ninv):
    """The kernel's arithmetic on the wrapper's tile images: the images
    read back into the (row, K) and ((shift, direction), K) operands,
    hi*hi + hi*lo + lo*hi in float64 with lo read as TF32, then the first
    max over shifts."""
    A, D, S = v.shape[0], u.shape[1], E.shape[1]
    a_hi, a_lo, b_hi, b_lo, n_kb, n_chunk, sc = kernels.kernel_operands(v, u, E)
    n_m, n_t, K = a_hi.shape[0], b_hi.shape[0], n_kb * kernels.KC
    assert torch.equal(kernels.round_tf32(a_hi), a_hi)
    assert torch.equal(kernels.round_tf32(b_hi), b_hi)

    def rows_a(x):
        return (kernels.round_tf32(x).permute(0, 2, 4, 1, 3, 5)
                .reshape(n_m * kernels.BM, K).double())

    def rows_b(x):
        return (kernels.round_tf32(x).permute(0, 1, 3, 5, 2, 4, 6)
                .reshape(n_t, n_chunk * sc, kernels.DT, K).double())

    ah, al, bh, bl = rows_a(a_hi), rows_a(a_lo), rows_b(b_hi), rows_b(b_lo)
    num = sum(torch.einsum("ak,tsdk->astd", x, y)
              for x, y in ((ah, bh), (ah, bl), (al, bh)))
    num = num.reshape(n_m * kernels.BM, n_chunk * sc, -1)[:A, :S, :D]
    best, idx = (num * ninv.double()[:, None]).max(1)
    return best.float(), idx.int()


@pytest.mark.parametrize("case", CASES + KERNEL_CASES)
def test_kernel_operands_emulated(case):
    args = torch_inputs(make_problem(**case))
    score, idx = emulate_kernel(*args)
    ref_score, ref_idx = kernels.shift_scored_match_plain(*args)
    scale = float(ref_score.abs().max())
    torch.testing.assert_close(score, ref_score, rtol=2e-5, atol=2e-4 * scale)
    assert (idx != ref_idx).float().mean().item() < 0.01
    if case.get("S") == 1:
        assert torch.all(idx == 0)


@pytest.mark.parametrize("S,chunks", [(1, (1, 1)), (29, (1, 29)),
                                      (32, (1, 32)), (33, (2, 17)),
                                      (49, (2, 25)), (97, (4, 25))])
def test_shift_chunks(S, chunks):
    n_chunk, sc = kernels.shift_chunks(S)
    assert (n_chunk, sc) == chunks
    assert sc <= kernels.SCMAX and n_chunk * sc >= S > (n_chunk - 1) * sc


def test_tf32_split():
    x = torch.from_numpy(np.random.RandomState(0).randn(1000)
                         .astype(np.float32) * 1e3)
    hi, lo = kernels.tf32_split_(x.clone())
    bits = hi.view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)
    assert torch.equal(hi + lo, x)
    assert torch.all(lo.abs() <= x.abs() * 2.0 ** -11)


def test_tile_layout_matches_cuda_source():
    # the .cu reads the tile images `kernel_operands` writes; on a card
    # `_launcher` asks the built library, here its source is read
    src = (Path(kernels.__file__).resolve().parent.parent / "csrc"
           / "shift_scored_match.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert {k: int(consts[k]) for k in ("BM", "DT", "KC", "SCMAX")} == dict(
        BM=kernels.BM, DT=kernels.DT, KC=kernels.KC, SCMAX=kernels.SCMAX)


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
@pytest.mark.parametrize("case", CASES + KERNEL_CASES + [SLICE_CASE])
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
    if case.get("S") == 1:
        assert torch.all(idx == 0)
