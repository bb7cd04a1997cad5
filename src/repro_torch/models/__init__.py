"""Model stack, dense family: layers, GQA attention with a KV cache (the
prefill through the flash-attention kernel), the decoder-only LM and the
``Model`` facade the serving engine drives."""

from repro_torch.models.api import Model, build_model, params_from_numpy

__all__ = ["Model", "build_model", "params_from_numpy"]
