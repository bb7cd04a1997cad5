"""Launch tools: the production, MoE and local device meshes over
``torch.distributed`` (``mesh``)."""
