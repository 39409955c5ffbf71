"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit). A card set below 700 W reaches less; the run
reports the card's name beside every number, and PERF.md its limit."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores, an FMA two FLOPs
TF32_FLOP_PER_S = 495e12
# float32 inputs multiplied to float32 accuracy on the tensor cores (three
# TF32 products, 495 / 3): the fastest way the card multiplies f32 matrices
F32_MATMUL_FLOP_PER_S = TF32_FLOP_PER_S / 3
BF16_FLOP_PER_S = 989e12

# the peak of a model's products by the configuration's compute dtype
MATMUL_PEAK = {"bfloat16": BF16_FLOP_PER_S, "float32": F32_MATMUL_FLOP_PER_S}
