"""The CUDA backend: ``CudaTable`` over torch tensors on one explicit
device (``device.py``), the per-graph CSR index, the fused expand
operators, and the hand-written Hopper kernels (``hopper/``)."""
