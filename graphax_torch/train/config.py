"""Typed, frozen configuration (port of `graphax/train/config.py`; the same
fields and defaults, so configs move between the packages unchanged).

The reference threads a single mutable flat ``opt: dict`` assembled from ~150
argparse flags through every constructor (`src/graph_datasets/run_GNN.py:282-440`,
test defaults `test/test_params.py:5-16`), and mutates it mid-flight
(`src/base_classes.py:152,161`). Here the same field names become a frozen
dataclass: field-compatible with every reference config dict (so
`best_params`-style dicts load directly via :meth:`Config.from_dict`), but
immutable — derived quantities (e.g. the Beltrami hidden width) are computed,
never written back.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple


@dataclass(frozen=True)
class Config:
    # -- data ----------------------------------------------------------
    dataset: str = "Cora"
    data_norm: str = "rw"              # 'rw' | 'gcn'
    self_loop_weight: float = 1.0
    use_labels: bool = False
    label_rate: float = 0.5
    geom_gcn_splits: bool = False
    num_splits: int = 1
    planetoid_split: bool = False
    not_lcc: bool = True               # reference flag name; True = use LCC
    batch_size: int = 1

    # -- GNN -----------------------------------------------------------
    hidden_dim: int = 16
    fc_out: bool = False
    input_dropout: float = 0.5
    dropout: float = 0.0
    batch_norm: bool = False
    optimizer: str = "adam"
    lr: float = 0.01
    decay: float = 5e-4
    epoch: int = 100
    alpha: float = 1.0
    alpha_dim: str = "sc"              # 'sc' scalar | 'vc' vector
    no_alpha_sigmoid: bool = False
    beta_dim: str = "sc"
    block: str = "constant"            # constant|mixed|attention|hard_attention|rewire_attention
    function: str = "laplacian"        # laplacian|transformer|GAT
    use_mlp: bool = False
    add_source: bool = False
    cgnn: bool = False

    # -- ODE -----------------------------------------------------------
    time: float = 1.0
    augment: bool = False
    method: str = "dopri5"             # dopri5|euler|rk4|midpoint|adaptive_heun
    step_size: float = 1.0
    max_iters: float = 100
    adjoint: bool = False
    adjoint_method: str = "adaptive_heun"
    adjoint_step_size: float = 1.0
    tol_scale: float = 1.0
    tol_scale_adjoint: float = 1.0
    ode_blocks: int = 1
    max_nfe: int = 1000
    # graphax option (no reference analog): rematerialize each RHS
    # evaluation in the backward pass; kept so configs carry over, unused by
    # the port, whose adjoint already keeps O(state) memory
    stage_remat: bool = False
    no_early: bool = False
    earlystopxT: float = 3.0
    max_test_steps: int = 100

    # -- attention -----------------------------------------------------
    leaky_relu_slope: float = 0.2
    attention_dropout: float = 0.0
    heads: int = 4
    attention_norm_idx: int = 0        # 0 = normalize over rows, 1 = cols
    attention_dim: int = 64
    mix_features: bool = False
    reweight_attention: bool = False
    attention_type: str = "scaled_dot" # scaled_dot|cosine_sim|pearson|exp_kernel
    square_plus: bool = False

    # -- regularization (None = off; value = coefficient) --------------
    jacobian_norm2: Optional[float] = None
    total_deriv: Optional[float] = None
    kinetic_energy: Optional[float] = None
    directional_penalty: Optional[float] = None

    # -- rewiring ------------------------------------------------------
    rewiring: Optional[str] = None     # two_hop | gdc
    gdc_method: str = "ppr"
    gdc_sparsification: str = "topk"
    gdc_k: int = 64
    gdc_threshold: float = 0.0001
    gdc_avg_degree: int = 64
    ppr_alpha: float = 0.05
    heat_time: float = 3.0
    att_samp_pct: float = 1.0
    use_flux: bool = False
    exact: bool = False
    M_nodes: int = 64
    new_edges: str = "random"
    sparsify: str = "S_hat"
    threshold_type: str = "topk_adj"
    rw_addD: float = 0.02
    rw_rmvR: float = 0.02
    rewire_KNN: bool = False
    rewire_KNN_T: str = "T0"
    rewire_KNN_epoch: int = 5
    rewire_KNN_k: int = 64
    rewire_KNN_sym: bool = False
    KNN_online: bool = False
    KNN_online_reps: int = 4
    KNN_space: str = "pos_distance"

    # -- beltrami ------------------------------------------------------
    beltrami: bool = False
    fa_layer: bool = False
    pos_enc_type: str = "DW64"
    pos_enc_orientation: str = "row"
    feat_hidden_dim: int = 64
    pos_enc_hidden_dim: int = 32
    pos_enc_dim: int = 0               # raw positional-encoding input width
    edge_sampling: bool = False
    edge_sampling_T: str = "T0"
    edge_sampling_epoch: int = 5
    edge_sampling_add: float = 0.64
    edge_sampling_add_type: str = "importance"
    edge_sampling_rmv: float = 0.32
    edge_sampling_sym: bool = False
    edge_sampling_online: bool = False
    edge_sampling_online_reps: int = 4
    edge_sampling_space: str = "attention"
    symmetric_attention: bool = False
    fa_layer_edge_sampling_rmv: float = 0.8
    pos_dist_quantile: float = 0.001

    # -- multimodal (fork additions) -----------------------------------
    multi_modal: bool = False
    second_modality_dim: int = 0

    # -- framework-native (no reference analog) ------------------------
    dtype: str = "float32"             # compute dtype for the ODE state
    seed: int = 12345
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("graph",)
    # >0: community-reorder node ids with this window size and use the
    # windowed SpMM layout
    community_window: int = 0

    # ------------------------------------------------------------------

    def __post_init__(self):
        if self.function in ("transformer", "GAT"):
            assert self.attention_dim % self.heads == 0, (
                f"heads ({self.heads}) must divide attention_dim "
                f"({self.attention_dim})")

    # Derived quantities the reference computes by mutating opt:

    def state_dim(self, num_features: int, num_classes: int) -> int:
        """Width of the ODE state x(t).

        Mirrors `BaseGNN.__init__`'s hidden_dim mutations
        (`src/base_classes.py:149-164`): Beltrami → feat+pos hidden dims;
        use_labels widens by num_classes; ANODE augmentation doubles.
        """
        d = (self.feat_hidden_dim + self.pos_enc_hidden_dim
             if self.beltrami else self.hidden_dim)
        if self.use_labels:
            d += num_classes
        if self.augment:
            d *= 2
        return d

    @property
    def atol(self) -> float:
        # Faithful to the reference: atol = tol_scale * 1e-7 > rtol
        # (`src/base_classes.py:57-62`).
        return self.tol_scale * 1e-7

    @property
    def rtol(self) -> float:
        return self.tol_scale * 1e-9

    @property
    def atol_adjoint(self) -> float:
        return self.tol_scale_adjoint * 1e-7

    @property
    def rtol_adjoint(self) -> float:
        return self.tol_scale_adjoint * 1e-9

    @property
    def n_reg(self) -> int:
        """Number of active regularizers (`src/base_classes.py:19-30`)."""
        return sum(c is not None for c in (
            self.kinetic_energy, self.jacobian_norm2, self.total_deriv,
            self.directional_penalty))

    def reg_coeffs(self) -> Tuple[Tuple[str, float], ...]:
        """(name, coeff) for active regularizers, in the reference's order
        (`src/regularized_ODE_function.py` + `base_classes.py:19-30`)."""
        order = (("kinetic_energy", self.kinetic_energy),
                 ("jacobian_norm2", self.jacobian_norm2),
                 ("total_deriv", self.total_deriv),
                 ("directional_penalty", self.directional_penalty))
        return tuple((n, c) for n, c in order if c is not None)

    # -- dict interop ---------------------------------------------------

    @classmethod
    def from_dict(cls, opt: Mapping[str, Any], **overrides) -> "Config":
        """Build from a reference-style flat opt dict, ignoring unknown keys."""
        names = {f.name for f in dataclasses.fields(cls)}
        merged: Dict[str, Any] = {}
        for k, v in opt.items():
            if k not in names:
                continue
            if v is None and not _field_optional(cls, k):
                continue
            merged[k] = v
        merged.update(overrides)
        return cls(**merged)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _field_optional(cls, name: str) -> bool:
    f = next(f for f in dataclasses.fields(cls) if f.name == name)
    return "Optional" in str(f.type) or f.default is None
