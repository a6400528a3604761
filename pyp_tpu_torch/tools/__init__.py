"""Tools of the port: the synthetic SPA dataset maker and its scoring
(`e2e_spa`), and the per-layer profile of the refinement loop on a CUDA
card (`profile_refine`)."""
