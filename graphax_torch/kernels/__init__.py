"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. A wrapper launches its kernel for CUDA tensors and uses the
plain version for CPU tensors; it never falls back from one to the other.

Modules: `spmm` (CSR SpMM, its CSC transpose and the SDDMM, with the
autograd Function of the laplacian RHS), `attention_pin`, and
`windowed_spmm` (densify and the three block products of the windowed
layout, `windows`); `dispatch` attaches that layout to a graph."""

from graphax_torch.kernels._build import LAUNCHES, build_all

__all__ = ["LAUNCHES", "build_all"]
