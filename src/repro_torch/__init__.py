"""PyTorch/CUDA port of the EchoPFL reproduction.

Mirrors the layout of the JAX package ``repro`` (the reference) and runs the
per-event asynchronous EchoPFL experiment on an NVIDIA GPU, with the
server's plane arithmetic in hand-written CUDA kernels (``kernels/``,
sources in ``csrc/``). Entry point:
``repro_torch.fl.experiment.run_experiment(task, "echopfl", device=...)``.
This package imports ``torch`` and ``numpy`` only.
"""
