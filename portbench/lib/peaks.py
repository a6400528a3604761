"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense,
at the 700 W limit). A roofline share is stated against these, with the
card's power limit beside it."""

BF16_FLOPS = 989e12        # tensor cores, bf16 in, f32 accumulate
TF32_FLOPS = 495e12        # tensor cores, tf32
FP32_FLOPS = 67e12         # CUDA cores, float32
HBM_BYTES = 3.35e12        # bytes/s


def least_seconds(flops_by_peak, nbytes):
    """The least time of a piece of work: the larger of its arithmetic time
    (operations over the peak of each kind they can exactly run at, summed)
    and its memory time (bytes over HBM bandwidth)."""
    compute = sum(f / peak for f, peak in flops_by_peak)
    return max(compute, nbytes / HBM_BYTES)
