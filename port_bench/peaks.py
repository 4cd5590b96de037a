"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit): the yardstick of
every roofline and MFU share the benchmark reports. A run prints the
card's own name and power limit beside them."""

BF16_FLOP_PER_S = 989e12      # tensor cores, bf16 / fp16 dense
F32_FLOP_PER_S = 67e12        # CUDA cores, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # HBM3
