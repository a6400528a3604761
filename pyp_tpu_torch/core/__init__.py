"""Core torch math: geometry, CTF model, FFT crops, filters, FSC."""

from pyp_tpu_torch.core import ctf, fft, filters, fsc, geometry  # noqa: F401
