"""Control plane: the fused per-tick decision, the closed control loop
over a fleet monitor service, the multi-tenant group and the decision
audit log (the JAX package's ``repro.control``)."""

from repro_torch.control.log import ControlLog, ControlRecord
from repro_torch.control.loop import ControlLoop
from repro_torch.control.policy import (AdmissionPolicy, BufferPolicy,
                                        ControlConfig, ControlState,
                                        Decision, PolicySet, ReplicaPolicy,
                                        SLOPolicy, control_decide,
                                        control_decide_trace_count,
                                        control_init)

__all__ = [
    "ControlLog", "ControlRecord", "ControlLoop",
    "ControlGroup", "CompositeActuator", "TenantHandle",
    "AdmissionPolicy", "BufferPolicy", "ReplicaPolicy", "SLOPolicy",
    "PolicySet", "ControlConfig", "ControlState", "Decision",
    "control_decide", "control_decide_trace_count", "control_init",
]

from repro_torch.control.group import (CompositeActuator,  # noqa: E402
                                       ControlGroup, TenantHandle)
