"""ssd3d_torch — the PyTorch and CUDA port of ssd3d for NVIDIA Hopper.

The JAX package `ssd3d/` is the reference; this package mirrors its layout
(`ssd3d_torch/ops/sampling.py` is the counterpart of `ssd3d/ops/sampling.py`)
and imports no JAX. It shares the JAX-free `ssd3d.config` and `ssd3d.data`.

Every point op that was a Pallas kernel on the TPU is a hand-written CUDA
kernel here (`csrc/`), built with nvcc at its first launch. Ops dispatch on the
device of their inputs: CUDA tensors launch the kernel, CPU tensors take the
plain PyTorch version kept beside it.
"""

__version__ = "0.1.0"
