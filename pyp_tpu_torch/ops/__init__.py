"""Compute operators of the ported slice: Fourier-slice gathers and
insertion, refine3d, reconstruct, and the hand-written CUDA kernels."""
