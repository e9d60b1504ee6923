"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. A wrapper launches its kernel for CUDA tensors and uses the
plain version for CPU tensors; it never falls back from one to the other.

Modules: `spmm` (CSR SpMM, its CSC transpose and the SDDMM, with the
autograd Function of the laplacian RHS), `attention_pin`,
`windowed_spmm` (densify and the three block products of the windowed
layout, `windows`; `dispatch` attaches that layout to a graph),
`fused_attention` (GRAND-nl's RHS over CSR, and the three-kernel form
under one global shift), `attention3` (the column-normalised route and the
replay Function of the routes whose backward is a plain twin), `winatt`
(GRAND-nl's windowed attention kernel K5 and its route;
`windowed_attention` holds the route's plain twin), and `flash_dense`
(GRAND-nl's masked flash attention on the dense strategy, whose other
operators are plain PyTorch in `dense_path`)."""

from graphax_torch.kernels._build import LAUNCHES, build_all

__all__ = ["LAUNCHES", "build_all"]
