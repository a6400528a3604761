"""Neural-network components (torch.nn): the learned particle picker, the
noise2noise and missing-wedge denoisers, the membrane segmenter, the
tomogram pattern miner, the micrograph quality model and the
heterogeneity VAE — the port of `pyp_tpu/models/`.

Every network is an `nn.Module` in NCHW / NCDHW layout built from the
flax-convention layers of `models.unet` (flax's "SAME" padding, its
transposed convolution, GroupNorm with eps 1e-6, lecun-normal
initialisation), and names its submodules as flax names them, so
`models.io` carries weights across the two packages in either
direction. Trainers are plain functions with an explicit `device`; the
draws the JAX package makes with `np.random.RandomState` stay numpy on
the host, in the same order.
"""
