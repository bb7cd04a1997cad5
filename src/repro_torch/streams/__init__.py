from repro_torch.streams.arena import CounterArena, EndStats, default_arena
from repro_torch.streams.queue import InstrumentedQueue
from repro_torch.streams.monitor_thread import (QueueMonitor, MonitorThread,
                                                FleetMonitorThread)
from repro_torch.streams.fleet import FleetMonitorService
from repro_torch.streams.pipeline import Stage, Pipeline, STOP

__all__ = ["CounterArena", "EndStats", "default_arena", "InstrumentedQueue",
           "QueueMonitor", "MonitorThread", "FleetMonitorThread",
           "FleetMonitorService", "Stage", "Pipeline", "STOP"]
