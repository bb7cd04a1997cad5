"""Flash-attention forward (causal GQA) for Hopper, with its plain
PyTorch version."""

from repro_torch.kernels.attention.ops import attention_ref, flash_attention

__all__ = ["flash_attention", "attention_ref"]
