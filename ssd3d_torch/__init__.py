"""ssd3d_torch — the PyTorch and CUDA port of ssd3d for NVIDIA Hopper.

The JAX package `ssd3d/` is the reference; this package mirrors its layout
(`ssd3d_torch/ops/sampling.py` is the counterpart of `ssd3d/ops/sampling.py`)
and imports nothing of JAX and nothing of the JAX package: what it needs of
a JAX-free module there it keeps as its own copy (`config.py`,
`utils/synth.py`). It covers flagship 3DSSD inference and training and
PointRCNN (two-stage) inference.

Every point op that was a Pallas kernel on the TPU is a hand-written CUDA
kernel here (`csrc/`, K1–K7: D-FPS, F-FPS, ball query, row gather, row
scatter-add, three_nn, fused set abstraction), built with nvcc at its first
launch. Ops dispatch on the device of their inputs: CUDA tensors launch the
kernel, CPU tensors take the plain PyTorch version kept beside it. The entry
points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
