"""Mamba-2 SSD intra-chunk step for Hopper, with its plain PyTorch
version and the chunked op built on it."""

from repro_torch.kernels.ssd.ops import ssd_chunk_ref, ssd_chunked

__all__ = ["ssd_chunked", "ssd_chunk_ref"]
