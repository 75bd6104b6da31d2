"""Grid, boundary, Poisson and multigrid ops, and the CUDA stencil kernels
(`stencil3d`, and `fused3d` for the flat engine)."""
