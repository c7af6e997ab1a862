"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
no sparsity), at its full 700 W power limit: the yardstick of every
roofline and MFU share. A run names the card and its power limit beside
them."""
BF16_FLOP_PER_S = 989e12      # tensor cores, bf16/fp16 dense
HBM_BYTES_PER_S = 3.35e12     # 80 GB HBM3
