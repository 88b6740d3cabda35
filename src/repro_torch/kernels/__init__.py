"""Hand-written CUDA kernels (sources in ``src/repro_torch/csrc/``): the
server's plane arithmetic (four families), the compressed uplink's cohort
encodes, and the LM task's flash attention forward and backward, each
beside its plain PyTorch version. See :mod:`repro_torch.kernels.ops` for
the public API."""
