"""The token data pipeline over the instrumented streaming substrate
(the JAX package's ``repro.data``)."""

from repro_torch.data.pipeline import (SyntheticLMSource, TextFileSource,
                                       DataPipeline, pack_tokens)

__all__ = ["SyntheticLMSource", "TextFileSource", "DataPipeline",
           "pack_tokens"]
