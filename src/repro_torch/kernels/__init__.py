"""Hand-written CUDA kernels for the server's plane arithmetic (four
families, sources in ``src/repro_torch/csrc/``), each beside its plain
PyTorch version. See :mod:`repro_torch.kernels.ops` for the public API."""
