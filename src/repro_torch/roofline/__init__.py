"""Roofline accounting: analytic FLOPs and HBM traffic over the configs
(``analytic``), the H100's peaks and the per-step roofline report
(``analysis``), and the collective bytes and FLOPs of a step counted
while it runs (``counters``, the twin of the JAX package's HLO parse)."""
