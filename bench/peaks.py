"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit). A share of a peak is stated against these,
with the card's power limit printed beside it."""

BF16_FLOPS = 989e12          # bf16 / fp16 tensor cores
TF32_FLOPS = 495e12
F32_FLOPS = 67e12            # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
MEMORY_BYTES = 80e9
