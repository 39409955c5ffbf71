"""Multi-GPU training over `torch.distributed` (counterpart of
`ssd3d/parallel/`): one process a card, `distributed.initialize_from_env`
starting the process group from the SSD3D_DIST_* contract, and
`data_parallel` (the counterpart of `ssd3d/parallel/mesh.py`) splitting the
global batch by rank and wrapping the train step for `dp` (DDP) or `fsdp`
(FSDP2). Modules are imported by name; this package imports none of them."""
