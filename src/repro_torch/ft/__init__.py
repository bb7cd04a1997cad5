"""Fault tolerance: seeded fault plans, heartbeats, fleet-scale straggler
tracking, elastic re-mesh plans and replica supervision (the JAX
package's ``repro.ft``)."""

from repro_torch.ft.failures import (FleetRateTracker,
                                     HeartbeatRegistry, HostRateTracker,
                                     ElasticPlan, plan_elastic_mesh,
                                     FaultToleranceManager)
"""Fault tolerance: seeded fault plans, heartbeats, fleet-scale straggler
tracking, elastic re-mesh plans and replica supervision (the JAX
package's ``repro.ft``)."""

from repro_torch.ft.inject import (FaultEvent, FaultPlan, FaultyActuator,
                                   InjectedFault)
"""Fault tolerance: seeded fault plans, heartbeats, fleet-scale straggler
tracking, elastic re-mesh plans and replica supervision (the JAX
package's ``repro.ft``)."""

from repro_torch.ft.supervisor import ReplicaSupervisor

__all__ = ["HeartbeatRegistry", "HostRateTracker", "FleetRateTracker",
           "ElasticPlan", "plan_elastic_mesh", "FaultToleranceManager",
           "FaultEvent", "FaultPlan", "FaultyActuator", "InjectedFault",
           "ReplicaSupervisor"]
