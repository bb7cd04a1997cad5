"""PyTorch + CUDA port of the online non-blocking service-rate monitor.

Mirrors the JAX package ``repro`` module for module, for the slices
ported so far: ``core`` (filters, streaming stats, Algorithm 1, queueing
model, controllers, tandem simulator), ``kernels`` (the fleet monitor,
flash attention and the SSD chunk step as hand-written Hopper CUDA
kernels, with their plain PyTorch versions), ``streams`` (counter arena,
instrumented queues, monitor threads, the fleet monitor service and the
pipeline), ``control`` (the fused decision, the loop and the group),
``ft`` (fault plans, heartbeats, rate trackers, the replica supervisor),
``workloads`` (the scenario foundry and its matrix), ``data`` (the token
pipeline), ``configs``, ``models`` (with the LM loss), ``serve``,
``obs``, ``train`` (optimizers, the train step, the trainer) and
``ckpt`` (checkpoints in the JAX package's layout).  The attention
kernel has a hand-written backward, so a model trains on the card.
Entry points run on the card unless given ``device="cpu"``.
"""
