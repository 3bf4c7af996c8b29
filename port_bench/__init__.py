"""The benchmark of torchio_tpu_torch on one NVIDIA GPU (see README.md)."""
