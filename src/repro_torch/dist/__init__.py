"""Distribution engine: logical-axis sharding rules + gradient compression.

``repro_torch.dist.api`` carries the active :class:`ShardingContext`
(mesh + rule tables) that ``constrain`` consults; ``repro_torch.dist.
sharding`` holds the rule tables, the greedy divisibility-aware
``spec_for`` resolver and the conversion of a spec to DTensor
placements over a ``DeviceMesh``; ``repro_torch.dist.compression``
implements the int8 error-feedback gradient compressor used on the
cross-pod axis, over ``torch.distributed``.
"""

from repro_torch.dist.api import (ShardingContext, active_context,
                                  constrain, use_sharding)

__all__ = ["ShardingContext", "active_context", "constrain",
           "use_sharding"]
