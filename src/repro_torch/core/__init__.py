# The paper's primary contribution: online non-blocking service-rate
# approximation (Beard & Chamberlain 2015) as a PyTorch module, plus the
# queueing model and run-time controllers it feeds.
from repro_torch.core.filters import (gaussian_kernel, log_kernel,
                                      convolve_valid, gaussian_filter_valid,
                                      log_filter_valid)
from repro_torch.core.stats import (Welford, welford_init, welford_update,
                                    welford_merge, welford_mean,
                                    welford_variance, welford_std,
                                    welford_stderr, Moments, moments_init,
                                    moments_update, moments_merge,
                                    moments_finalize)
from repro_torch.core.monitor import (MonitorConfig, MonitorState,
                                      MonitorOutput, monitor_init,
                                      monitor_update, run_monitor,
                                      FleetMonitorState, fleet_monitor_init,
                                      run_monitor_fleet, HostMonitor,
                                      SamplingPeriodController, Z_95)
from repro_torch.core.queueing import (pr_nonblocking_read,
                                       pr_nonblocking_write, mm1k_throughput,
                                       mm1k_blocking_prob,
                                       mm1k_mean_occupancy,
                                       optimal_buffer_size)
from repro_torch.core.controller import (BufferAutotuner,
                                         ParallelismController,
                                         StragglerDetector,
                                         DistributionClassifier)
from repro_torch.core.simulate import (TandemConfig, TandemResult,
                                       simulate_tandem, sample_periods,
                                       sample_periods_fleet)

__all__ = [n for n in dir() if not n.startswith("_")]
