"""Architecture and shape configurations: frozen dataclasses, the same
as the JAX package's ``repro.configs``."""

from repro_torch.configs.base import (ArchConfig, ShapeConfig, SHAPES,
                                      applicable, pad_vocab)
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_smoke_config, get_shape,
                                          all_cells)

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "applicable", "pad_vocab",
           "ARCH_IDS", "get_config", "get_smoke_config", "get_shape",
           "all_cells"]
