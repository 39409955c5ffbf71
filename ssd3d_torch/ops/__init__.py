"""Point ops: sampling, grouping, NMS. The CUDA kernels are built at their
first launch by `ssd3d_torch.ops._build`, which also keeps their launch
counts."""
