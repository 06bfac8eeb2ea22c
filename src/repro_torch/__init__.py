"""PyTorch port of ``repro`` for NVIDIA Hopper: the layered checkpoint store
with on-device fingerprinted incremental saves, and the dense model served
from it. Self-contained: it imports nothing of ``repro`` and no JAX."""
