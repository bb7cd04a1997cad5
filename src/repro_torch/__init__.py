"""PyTorch + CUDA port of the online non-blocking service-rate monitor.

Mirrors the JAX package ``repro`` module for module, for the slices
ported so far: ``core`` (filters, streaming stats, Algorithm 1, queueing
model, controllers, tandem simulator), ``kernels.monitor`` (the fused
fleet scan and the per-tick window stage as hand-written Hopper CUDA
kernels, with their plain PyTorch versions) and ``streams`` (counter
arena, instrumented queues, monitor threads and the fleet monitor
service).  Entry points run on the card unless given ``device="cpu"``.
"""
