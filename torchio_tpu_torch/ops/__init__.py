"""Device ops: the resample and its CUDA kernel."""
