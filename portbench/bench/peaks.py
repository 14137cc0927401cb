"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, no sparsity),
the yardstick of every roofline and mfu metric.  They assume the card's full
700 W power limit; each result line reports the card's limit beside them."""

BF16_FLOPS = 989e12  # dense bf16 / fp16 tensor-core FLOP/s
F32_FLOPS = 67e12  # f32 outside the tensor cores
INT8_OPS = 1979e12  # dense int8 tensor-core OP/s
HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth
