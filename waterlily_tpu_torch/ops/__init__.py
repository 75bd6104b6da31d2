"""Grid, boundary, Poisson and multigrid ops, and the CUDA stencil kernels."""
