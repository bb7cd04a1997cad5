"""Control plane, first part: the decision audit log and the policy
objects.  The control loop and its fused decision are not ported yet
(ROADMAP.md, Queue 1 item 1)."""

from repro_torch.control.log import ControlLog, ControlRecord
from repro_torch.control.policy import (AdmissionPolicy, BufferPolicy,
                                        ControlConfig, PolicySet,
                                        ReplicaPolicy, SLOPolicy)

__all__ = ["ControlLog", "ControlRecord", "AdmissionPolicy", "BufferPolicy",
           "ControlConfig", "PolicySet", "ReplicaPolicy", "SLOPolicy"]
