"""Checkpoints: asynchronous, atomic, with auto-resume (the JAX package's
``repro.ckpt``, same layout on disk)."""

from repro_torch.ckpt.manager import CheckpointManager

__all__ = ["CheckpointManager"]
