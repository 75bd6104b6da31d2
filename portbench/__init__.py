"""The benchmark of waterlily_tpu_torch: see README.md."""
