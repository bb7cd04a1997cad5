"""Fleet service-rate monitor kernels (Algorithm 1) for Hopper."""

from repro_torch.kernels.monitor.kernel import (batched_monitor,
                                                monitor_fleet)
from repro_torch.kernels.monitor.ops import (FleetStepState,
                                             fleet_monitor_q,
                                             fleet_monitor_scan,
                                             fleet_monitor_step,
                                             fleet_step_init)
from repro_torch.kernels.monitor.ref import (batched_monitor_ref,
                                             monitor_fleet_ref)

__all__ = ["batched_monitor", "monitor_fleet", "batched_monitor_ref",
           "monitor_fleet_ref", "fleet_monitor_scan", "fleet_monitor_q",
           "fleet_monitor_step", "fleet_step_init", "FleetStepState"]
