"""Flash attention (GQA, causal or not) for Hopper, forward and backward,
with its plain PyTorch versions."""

from repro_torch.kernels.attention.ops import attention_ref, flash_attention

__all__ = ["flash_attention", "attention_ref"]
