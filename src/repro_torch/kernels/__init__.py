# Hand-written Hopper kernels for the compute hot spots of the port, one
# subpackage each: <name>/ref.py (plain PyTorch versions), kernel.py (build,
# binding, wrappers), ops.py (public ops) and csrc/ (CUDA C++ sources).
