"""GRAND-l: linear graph diffusion RHS (port of
`graphax/functions/laplacian.py`).

``f = alpha (A x - x) [+ beta x0]`` where A carries the graph's rw/gcn
weights or the attention pinned by the enclosing block. The SpMM is the
hand-written CSR kernel with its CSC/SDDMM backward
(`graphax_torch.kernels.spmm`), or on a windowed graph the block-dense
product plus the residual CSR SpMM (`graphax_torch.kernels.windowed_spmm`,
`graphax/functions/laplacian.py:39-46`), or on a dense graph the product
with the ``[N, N]`` operator densified once per forward
(`graphax/functions/laplacian.py:34-37`): a plain matrix product outside
any Pallas kernel in graphax, ``torch.matmul`` (cuBLAS) here, in the state
dtype with f32 sums (`graphax_torch.kernels.dense_path.dense_matmul`)."""

from __future__ import annotations

import torch
from torch import nn

from graphax_torch.functions.common import apply_alpha_beta, init_alpha_beta
from graphax_torch.kernels.dense_path import dense_matmul
from graphax_torch.kernels.spmm import spmm
from graphax_torch.kernels.windowed_spmm import spmm_windowed


def laplacian_rhs(cfg, graph, alpha, beta, x0, wb, wb_t, x, dense=None):
    if graph.strategy == "dense":
        ax = dense_matmul(dense, x)
    elif graph.strategy == "windowed":
        ax = spmm_windowed(dense, wb, wb_t, x, graph.windows)
    else:
        ax = spmm(graph, wb, wb_t, x)
    return apply_alpha_beta(cfg, alpha, beta, ax, x, x0)


class LaplacianFunction(nn.Module):
    def __init__(self, cfg, in_dim: int):
        super().__init__()
        if cfg.multi_modal:
            raise NotImplementedError("multimodal cross-attention is not "
                                      "ported yet (ROADMAP Queue 1, M9)")
        self.cfg = cfg
        init_alpha_beta(self)

    def reset_parameters(self, generator=None) -> None:
        nn.init.zeros_(self.alpha_train)
        nn.init.zeros_(self.beta_train)

    def rhs(self, alpha, beta, fstate, t, x):
        return laplacian_rhs(self.cfg, fstate.graph, alpha, beta, fstate.x0,
                             fstate.wb, fstate.wb_t, x, dense=fstate.dense)
