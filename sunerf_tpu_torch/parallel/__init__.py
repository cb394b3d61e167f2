"""Data parallelism over torch.distributed (sunerf_tpu/parallel)."""
