"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit)."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # outside the tensor cores: the sampler kernels' arithmetic
BF16_FLOP_PER_S = 989e12  # dense tensor-core bf16: the served model's GEMMs and convolutions
