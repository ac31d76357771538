"""Device kernels of the PyTorch port and their host work-list builders."""
