"""``repro_torch.workloads`` — the scenario foundry (the JAX package's
``repro.workloads``).

Seedable, composable workload generation + chaos-soak harnessing for
the control plane: arrival-rate envelopes (:mod:`.arrivals`),
simulated tandem stages behind the real actuator protocol
(:mod:`.sim`), named scenario x policy x fault specs
(:mod:`.scenario`), the cell/matrix driver (:mod:`.harness`) and
trace record/replay (:mod:`.trace`).

The same seeds draw the same numpy random streams as the JAX package,
so a cell's row and a trace's decisions match it; ``run_cell``,
``run_matrix`` and ``replay`` run their monitor service and decision on
``device`` (the card by default).
"""

from repro_torch.workloads.arrivals import (Boxcar, Clip, Constant,
                                            Diurnal, FlashCrowd, Process,
                                            Product, Ramp, Shift, Square,
                                            Step, Sum, as_process)
from repro_torch.workloads.harness import (CellResult, StormDriver,
                                           run_cell, run_matrix)
from repro_torch.workloads.scenario import (FAULTS, POLICIES, SCENARIOS,
                                            FaultStorm, Scenario,
                                            TenantSpec, make_policies)
from repro_torch.workloads.sim import (ParetoService, PoissonService,
                                       ServiceModel, SimActuator,
                                       SimTandem)
from repro_torch.workloads.trace import (DECISION_FIELDS, ReplayActuator,
                                         Trace, TraceRecorder, replay)

__all__ = [
    "Process", "Constant", "Step", "Ramp", "Square", "Diurnal", "Boxcar",
    "FlashCrowd", "Sum", "Product", "Clip", "Shift", "as_process",
    "ServiceModel", "PoissonService", "ParetoService", "SimTandem",
    "SimActuator",
    "TenantSpec", "Scenario", "FaultStorm", "SCENARIOS", "FAULTS",
    "POLICIES", "make_policies",
    "StormDriver", "CellResult", "run_cell", "run_matrix",
    "DECISION_FIELDS", "Trace", "TraceRecorder", "ReplayActuator",
    "replay",
]
