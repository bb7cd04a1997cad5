"""Serving: batched prefill + greedy decode behind per-QoS-class request
lanes watched by the fleet monitor."""

from repro_torch.serve.engine import (AdmissionGate, Engine, Request,
                                      ServeConfig)
from repro_torch.serve.qos import (BLOCKING, NONBLOCKING, QoSClass,
                                   qos_class, qos_classes,
                                   register_qos_class)

__all__ = ["Request", "ServeConfig", "Engine", "AdmissionGate",
           "QoSClass", "register_qos_class", "qos_class", "qos_classes",
           "BLOCKING", "NONBLOCKING"]
