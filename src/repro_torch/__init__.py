"""PyTorch port of ``repro`` for NVIDIA Hopper: the layered checkpoint store
with on-device fingerprinted incremental saves, the dense, ssm and hybrid
models served from it, and their training on one device. Self-contained:
it imports nothing of ``repro`` and no JAX."""
