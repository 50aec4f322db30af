"""Kernels of the port: hand-written CUDA for Hopper plus their plain
PyTorch versions (:mod:`repro_torch.kernels.ref`)."""
