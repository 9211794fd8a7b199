"""Data-parallel training across ranks: one process a rank, torch.distributed
(port of audiobd_tpu/parallel/)."""
