"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity), at its full 700 W power limit."""

HBM_BYTES_PER_S = 3.35e12
DENSE_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
               "float32": 67e12, "fp8": 1979e12}
