"""Where the time of the redesigned kernels goes, on the card: each built
again from this checkout's source with parts of its loop switched off (or
a compile-time constant changed), and timed beside the intact kernel at
the ogbn-arxiv preset's shapes.

``--only winatt_gmax`` (the default runs every group):

- ``winatt_kernel`` (K5) on path A's inputs (the windowed GRAND-nl model's
  own q, k and x, r0 and d_res from the residual; bf16): intact; without
  the x gathers; without the score loads of q and k; without the output
  stores (the aggregate then compiles away: the score phase and den
  alone); with both loads off (the stores, the cell lists and the
  shuffles alone); each at 32, 16 and 8 lanes a row (the kernel's
  ``LANES``, 16 intact; the host's plan sends the rows of more cells to
  the segment kernels); and at 16 lanes, builds with 2, 3, 5 or 6 blocks
  an SM (``MIN_BLOCKS``, 4 intact: the register cap) and with 24 words of
  x rows in flight a lane (``WORDS``, 12 intact); and on chip_smoke's
  ``long_row_windows`` (in-window rows of up to 512 cells, their segments
  in the segment kernels) intact, without the x gathers, without the
  score loads and without the output stores.
- ``gmax_kernel`` on the windowed residual and on the whole arxiv CSR
  (bf16 q, f32 K): intact; without the slot-to-row reads (every slot
  scored against row 0's q: what the 8-byte seg costs); without the K
  loads; blocks of 128 and 512 threads (``GM_THREADS``, 256 intact);
  the grid one pair a thread instead of capped at the resident blocks;
  no register cap, or one of 8 blocks an SM (``GM_MIN_BLOCKS``, 4
  intact).

``--only bwd_cols_norm``: the column backward (B3) and attention_norm,
bf16:

- ``bwd_cols_kernel`` on the CSR GRAND-nl model's operands (its encoded
  state, q, the K table, the training forward's tables and rho, a
  cotangent from a seed) over the arxiv CSC: intact; without the g
  gathers; without the scores (alpha from a score of 0); without the dk
  sums; without the dk and dxv stores; with 6, 9 or 24 words of g rows
  in flight a lane (``B3_WORDS``, 12 intact: 2, 3 and 8 rows at the bf16
  arxiv width against 4); with 3 or 5 blocks an SM (``B3_MIN_BLOCKS``, 4
  intact: the register cap); with 4 q rows in flight in the dk sums
  (``UQ``, 8 intact); and intact on the transposed
  ``chip_smoke.hub_graph`` (hub columns in segments).
- ``norm_kernel`` on the windowed residual (path A's operands, r0) and
  the whole arxiv CSR (the CSR model's): intact; without the score loads;
  without the e stores; without both; at 16 and 32 lanes a row
  (``NM_LANES``, 8 intact); with the cutover and segment length at 16
  and 64 slots (``NM_CUT`` and ``NM_SEG``, 32 intact; the host's plan
  made to match); with 3 or 5 blocks an SM (``NM_MIN_BLOCKS``, 4
  intact).

``--only fwd_res_bwd_rows``: the training forward (attention_fwd_res)
and the row backward (attention_bwd_rows), bf16, on the CSR GRAND-nl
model's operands (its encoded state, q, the K table, a cotangent from a
seed; the backward on the plain forward's residuals) over the arxiv CSR:
intact; without the x gathers (both kernels); without the forward's
scores (alpha from a score of 0); without both; without the backward's
dq sums; the forward with 2 and 8 x rows in flight (the
walk's ``U``, 4 intact) and 3 and 5 blocks an SM (``FR_MIN_BLOCKS``, 4
intact); the backward with 1 and 4 x rows in flight (``BR_ROWS``, 2
intact) and 4, 5 and 8 blocks an SM (``BR_MIN_BLOCKS``, 6 intact), and
with 4 rows and 4 blocks (the first build's); and on
``chip_smoke.hub_graph``'s CSR (hub rows in segments) intact, the
forward with segments of 32, 64, 128 and 256 edges (``ROW_SPLIT`` 128
intact; the backward's are one batch of 32).

``--only kproj_slab``: the CUDA-core K projection and bf16 win_bwd_slab:

- ``kproj_kernel`` at the arxiv widths (N 169,343, D 162, A 32: 8-byte
  copies of x) and at D 160 (16-byte copies): intact; without its FMAs
  (the staging alone); without its staging (the FMAs on whatever the
  ring holds); beside ``addmm(out_dtype=float32)`` and ``x.clone()``
  (x read and written once).
- ``win_bwd_slab_tc_kernel`` (bf16 blocks and g, bf16 output) on the
  windowed arxiv layout: intact; without the blocks' staging; without
  g's (its 4-byte copies); without the MMAs; with only the loop's
  barriers and the stores left.

``--only f32_core``: the f32 bodies of win_matmul, win_bwd_dense and
win_bwd_slab (their shared FMA core) at the windowed arxiv shapes (f32
blocks, x, g and addend from a seed; win_bwd_dense with f32 and bf16
output): intact; without the FMAs (the staging, barriers and stores
alone); without the staging (the FMAs on whatever the ring holds); with
one CTA an SM, the registers uncapped (``F_CTAS_MM``, ``F_CTAS_BD``, 2
intact); win_matmul and win_bwd_slab with steps of 16 k and a ring of 3
(``F_BK_MM`` 32, ``F_ST_MM`` 2 intact), with a ring of 3 (one CTA an SM
then fits), and with 8 x 8 register tiles (128 columns of D a CTA, two
CTAs over D = 162: ``F_NR_MM`` 2, 3 intact); win_bwd_dense with steps
of 32 k (``F_BK_BD``, 16 intact), with rings of 3 and 4 (``F_ST_BD``, 2
intact), and with 8 x 16 tiles and one CTA an SM (256 columns a CTA:
``F_NR_BD`` 4, 2 intact); win_matmul reading its addend a value at a time
(16- or 8-byte loads intact); each beside ``bmm`` / ``baddbmm`` on the
pre-gathered slab.

``--only sddmm``: the SDDMM (g and x from a seed, D 162, f32 output) on
the arxiv CSR, the windowed residual and ``chip_smoke.hub_graph``, bf16
and f32: intact; without the x gathers (row_walk.cuh's ``batch_dots``);
with 1 and 4 x rows in flight (``SD_ROWS``, 2 intact); with 6 blocks an
SM in bf16 and 4 in f32, and with 8 in both (``min_blocks``, shared with
the SpMM walk: 8 and 6 intact).

``--only beltrami``: the beltrami_exp instances of flash_kernel (and
its segment kernels), gmax_kernel, the pin's three kernels and
norm_kernel at path (b)'s shapes (the BLEND GRAND-nl preset's operands
as ``torch_kernel_redesign.blend_operands`` makes them: N 169,343, D
162, the K table 2 x 32 wide, 2 heads), bf16 and f32: flash (softmax,
f32 out) on the arxiv CSR and on ``chip_smoke.hub_graph``, and in bf16
also on the arxiv CSR with x two columns wider (D 164, so 8-byte x
loads: the VB 8 instance), gmax on the arxiv CSR; each on its 16-byte
route and on its one-value route (the host's kvec / qvec forced to 0);
intact (flash at 5 blocks an SM, ``FLASH_MIN_BLOCKS``; gmax at 4,
``GM_MIN_BLOCKS``), then flash at 6, 7, 6 and 4 blocks beside gmax at 2,
6, 8 and 3 (each constant sets the other score types' instances too,
which these cases do not time). The pin (its walk on the K table) on the
arxiv CSR, the hub graph and ``torch_kernel_redesign.regular_graph``
(the kNN graph's shape), each route, at 6 blocks an SM (intact,
``BEL_MIN_BLOCKS``), 4 and 5; the norm on the arxiv CSR and the hub
graph, each route, at 4 blocks (intact, ``NM_BEL_MIN_BLOCKS``), 3 and 5.
Each build's output against the intact build's, bit for bit, and its
``-Xptxas=-v`` lines in ``results/ablations/``.

``--only scoring [--parent DIR]``: the other score types' flash and pin
kernels once the first-form beltrami_exp helper (a ``__noinline__`` call
inside ``score()``) left the source, at GRAND-nl's arxiv widths (D 162,
A 32, 2 heads; q, x, Wk from a seed) on the arxiv CSR, the hub graph and
``torch_kernel_redesign.pareto_graph``: flash (softmax and squareplus)
and the pin's walk for scaled_dot, cosine_sim and exp_kernel in bf16 and
scaled_dot in f32, intact; with ``score()`` made a call again
(``score_call``); with flash_seg_sum's instances other than
beltrami_exp's at 4 blocks an SM (``seg_sum_4``); both; and the parent
checkout's libraries on the same inputs. Each output against the intact
build's, bit for bit; on the hub and power-law graphs each kernel's
device microseconds a call (torch.profiler).

A switched-off part leaves the results wrong: only the intact builds are
checked (against the plain versions). Each ablated build is a copy of the
source with guards on the switched-off statements and the case's
constants substituted by text, compiled by ``nvcc`` into
``results/ablations/`` (ignored by git) with the flag set to the case's
bits, and called through the same C interface as the port. One JSON
line per measurement (device ms as chip_smoke's ``time_ms`` takes them),
then the card's nvidia-smi line. Run from the root of the repo on the
card: ``python3 scripts/torch_kernel_ablations.py [--only
winatt_gmax|kproj_slab|bwd_cols_norm|fwd_res_bwd_rows|f32_core|sddmm|
beltrami|scoring]``.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
OUT = os.path.join(HERE, "results", "ablations")

# (source, flag, [(statement, guarded statement)], headers): the guard
# drops the statement where the flag's bit is set; the headers are copied
# into the source first, so their statements can be guarded too
KPROJ = ("fused_attention", "KPROJ_OFF", [
    ("      kc_stage_rows<T, KC_BM, KC_BK>(",
     "      if (!(KPROJ_OFF & 2)) kc_stage_rows<T, KC_BM, KC_BK>("),
    ("      kc_stage_rows<T, KC_BK, BN>(",
     "      if (!(KPROJ_OFF & 2)) kc_stage_rows<T, KC_BK, BN>("),
    ("      if (k < kend) {  // columns past D are zeros on both sides",
     "      if (!(KPROJ_OFF & 1) && k < kend) {"),
], ())
SLAB = ("windowed_spmm", "SLAB_OFF", [
    ("    for (int i = tid; i < MM_BK * (MM_BM / 8); i += MM_THREADS) {",
     "    for (int i = tid; i < (SLAB_OFF & 2 ? 0 : MM_BK * (MM_BM / 8));"
     " i += MM_THREADS) {"),
    ("    stage_pairs<ASYNC>(Bs, g, first, MM_BK,",
     "    if (!(SLAB_OFF & 4)) stage_pairs<ASYNC>(Bs, g, first, MM_BK,"),
    ("    for (int kk = 0; kk < MM_BK; kk += 16) {\n"
     "      uint32_t a[2][4];\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < 2; ++i)\n"
     "        gx_tc::ldmatrix_x4_trans(",
     "    for (int kk = 0; kk < (SLAB_OFF & 1 ? 0 : MM_BK); kk += 16) {\n"
     "      uint32_t a[2][4];\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < 2; ++i)\n"
     "        gx_tc::ldmatrix_x4_trans("),
], ())
WINATT = ("winatt", "WINATT_OFF", [
    ("          if (v0 + v * G + l < nvec) ldv<VB>(xr + v * G * V::E, "
     "raw[u][v]);",
     "          if (!(WINATT_OFF & 1) && v0 + v * G + l < nvec) "
     "ldv<VB>(xr + v * G * V::E, raw[u][v]);"),
    ("          if (t < nh && i0 + u * EV < dk) {\n"
     "            qv[t][u] = __ldg(",
     "          if (!(WINATT_OFF & 2) && t < nh && i0 + u * EV < dk) {\n"
     "            qv[t][u] = __ldg("),
    ("    if (vi < nvec) store_vec<E>(out, 0, nullptr,",
     "    if (!(WINATT_OFF & 4) && vi < nvec) store_vec<E>(out, 0, nullptr,"),
], ())
GMAX = ("fused_attention", "GMAX_OFF", [
    ("      const T* qh = q + (size_t)__ldg(seg + e) * a + hh * dk;",
     "      const T* qh = q + (GMAX_OFF & 1 ? (size_t)0 : "
     "(size_t)__ldg(seg + e)) * a + hh * dk;"),
    ("        if (i0 + 4 * t < dk)\n"
     "          k[t] = __ldg(reinterpret_cast<const float4*>(kr + i0 + 4 * t));",
     "        if (!(GMAX_OFF & 2) && i0 + 4 * t < dk)\n"
     "          k[t] = __ldg(reinterpret_cast<const float4*>(kr + i0 + 4 * t));"),
    ("  if (grid > resident) grid = resident;",
     "  if (!(GMAX_OFF & 4) && grid > resident) grid = resident;"),
], ("attention_score.cuh",))

B3 = ("fused_attention", "B3_OFF", [
    ("      load_rows<T, VB, VPL, U>(raw, g, r, e0, cnt, d, v0, nvec, lane);",
     "      if (!(B3_OFF & 1)) load_rows<T, VB, VPL, U>(raw, g, r, e0, cnt, "
     "d, v0, nvec, lane);"),
    ("      const float s = gx_att::score_head<T, true>(",
     "      const float s = (B3_OFF & 2) ? 0.f : gx_att::score_head<T, true>("),
    ("    for (int j0 = 0; j0 < cnt; j0 += UQ) {",
     "    for (int j0 = 0; j0 < (B3_OFF & 4 ? 0 : cnt); j0 += UQ) {"),
    ("    if (i < a) out[i] = s;",
     "    if (!(B3_OFF & 8) && i < a) out[i] = s;"),
    ("    store_chunk<T, VB, VPL>(acc, dxv_out, 0, nullptr, 0, v0, nvec, "
     "lane);",
     "    if (!(B3_OFF & 8)) store_chunk<T, VB, VPL>(acc, dxv_out, 0, "
     "nullptr, 0, v0, nvec, lane);"),
], ())
NORM = ("fused_attention", "NORM_OFF", [
    ("          s = KV ? gx_att::score_head<T, true>(",
     "          s = (NORM_OFF & 1) ? 0.f : KV ? gx_att::score_head<T, "
     "true>("),
    ("        eo[(size_t)e * h + hh] = v;",
     "        if (!(NORM_OFF & 2)) eo[(size_t)e * h + hh] = v;"),
], ())

# row_walk.cuh's batch_dots (the row backward's and the SDDMM's dot
# products): its gather of the batch's x rows
BATCH_LOADS = ("      load_rows<T, VB, VPL, U>(raw, x, col, e0, cnt, d, v0, "
               "nvec, lane);")

# the training forward and the row backward: 1 the forward's x gathers, 2
# its scores, 4 the backward's x gathers, 8 its dq sums
FRBR = ("fused_attention", "FRBR_OFF", [
    ("    gather<T, VB, VPL, U<VB>>(acc, x, col, wt, len, d, v0, nvec, lane);",
     "    if (!(FRBR_OFF & 1)) gather<T, VB, VPL, U<VB>>(acc, x, col, wt, len, "
     "d, v0, nvec, lane);"),
    ("    batch_scores(qs, kt, idx, nullptr, beg, len, a, h, 0, gx_att::Scal{},",
     "    if (!(FRBR_OFF & 2)) batch_scores(qs, kt, idx, nullptr, beg, len, "
     "a, h, 0, gx_att::Scal{},"),
    (BATCH_LOADS, BATCH_LOADS.replace(
        "      load_rows", "      if (!(FRBR_OFF & 4)) load_rows")),
    ("  lane_sums(ws, kt, col, cnt, a, h, dq + (size_t)r * a, lane);",
     "  if (!(FRBR_OFF & 8)) lane_sums(ws, kt, col, cnt, a, h, "
     "dq + (size_t)r * a, lane);"),
], ("attention_score.cuh", "row_walk.cuh"))

# the SDDMM: 1 the x gathers
SDDMM = ("spmm", "SD_OFF", [
    (BATCH_LOADS, BATCH_LOADS.replace(
        "      load_rows", "      if (!(SD_OFF & 1)) load_rows")),
], ("row_walk.cuh",))

# the f32 core: 1 the FMAs, 2 the staging
F32 = ("windowed_spmm", "F32_OFF", [
    ("    const int kn = klen(s);",
     "    const int kn = (F32_OFF & 1) ? 0 : klen(s);"),
    ("    if (s < nsteps) stage(s, slot, slot + S::BK * F_PA);",
     "    if (!(F32_OFF & 2) && s < nsteps) stage(s, slot, slot + S::BK * "
     "F_PA);"),
    ("    if (sn < nsteps) {\n      float* slot",
     "    if (!(F32_OFF & 2) && sn < nsteps) {\n      float* slot"),
], ())


def const(name: str, old: int, new: int) -> tuple:
    """The substitution that sets the source's ``constexpr int name``
    from ``old`` to ``new``."""
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


# each case: the bits of the parts switched off (kproj: 1 the products, 2
# the staging; slab: 1 the MMAs, 2 the blocks' staging, 4 g's; winatt: 1
# the x gathers, 2 the score loads, 4 the output stores; gmax: 1 the
# slot-to-row reads, 2 the K loads, 4 the grid's cap; B3: 1 the g
# gathers, 2 the scores, 4 the dk sums, 8 the stores; norm: 1 the score
# loads, 2 the e stores), or the bits and the constants substituted
KPROJ_CASES = {"intact": 0, "no_fma": 1, "no_staging": 2}
SLAB_CASES = {"intact": 0, "no_mma": 1, "no_block_staging": 2,
              "no_g_staging": 4, "barriers_and_stores": 7}
K5_PARTS = {"intact": 0, "no_x_gather": 1, "no_score_loads": 2,
            "no_out_stores": 4, "stores_and_lists": 3}
K5_LANES = (32, 16, 8)
WINATT_CASES = {
    **{(part, g): (bits, [const("LANES", 16, g)] if g != 16 else [])
       for part, bits in K5_PARTS.items() for g in K5_LANES},
    **{(f"min_blocks_{m}", 16): (0, [const("MIN_BLOCKS", 4, m)])
       for m in (2, 3, 5, 6)},
    ("words_24", 16): (0, [const("WORDS", 12, 24)])}
GMAX_CASES = {"intact": 0, "no_seg": 1, "no_k_loads": 2,
              "threads_128": (0, [const("GM_THREADS", 256, 128)]),
              "threads_512": (0, [const("GM_THREADS", 256, 512)]),
              "uncapped_grid": 4,
              "no_register_cap": (0, [const("GM_MIN_BLOCKS", 4, 1)]),
              "min_blocks_8": (0, [const("GM_MIN_BLOCKS", 4, 8)])}

B3_CASES = {"intact": 0, "no_g_gather": 1, "no_scores": 2,
            "no_dk_sums": 4, "no_stores": 8,
            **{f"words_{w}": (0, [const("B3_WORDS", 12, w)])
               for w in (6, 9, 24)},
            **{f"min_blocks_{m}": (0, [const("B3_MIN_BLOCKS", 4, m)])
               for m in (3, 5)},
            "q_rows_4": (0, [const("UQ", 8, 4)])}
# the norm's cutover (and segment length) of each case that changes it
NORM_CUTS = {f"cut_{c}": c for c in (16, 64)}
NORM_CASES = {"intact": 0, "no_scores": 1, "no_e_stores": 2,
              "no_scores_or_stores": 3,
              **{f"lanes_{g}": (0, [const("NM_LANES", 8, g)])
                 for g in (16, 32)},
              **{k: (0, [const("NM_CUT", 32, c), const("NM_SEG", 32, c)])
                 for k, c in NORM_CUTS.items()},
              **{f"min_blocks_{m}": (0, [const("NM_MIN_BLOCKS", 4, m)])
                 for m in (3, 5)}}

F32_CASES = {"intact": 0, "no_fma": 1, "no_staging": 2,
             "one_cta_an_sm": (0, [const("F_CTAS_MM", 2, 1),
                                   const("F_CTAS_BD", 2, 1)]),
             "matmul_slab_steps_16_ring_3": (
                 0, [const("F_BK_MM", 32, 16), const("F_ST_MM", 2, 3)]),
             "matmul_slab_ring_3": (0, [const("F_ST_MM", 2, 3)]),
             "matmul_slab_tile_8x8": (0, [const("F_NR_MM", 3, 2)]),
             "dense_steps_32": (0, [const("F_BK_BD", 16, 32)]),
             **{f"dense_ring_{n}": (0, [const("F_ST_BD", 2, n)])
                for n in (3, 4)},
             "dense_tile_8x16_one_cta_an_sm": (
                 0, [const("F_NR_BD", 2, 4), const("F_CTAS_BD", 2, 1)]),
             "matmul_addend_by_value": (
                 0, [("f_add(v, addend + (p - out), n, vb);",
                      "f_add(v, addend + (p - out), n, 1);")])}

# x rows in flight in the forward's gather (the walk's U, shared with
# flash and attspmm: only the forward is timed with it changed)
FR_ROWS = "template <int VB> constexpr int U = VB <= 4 ? 4 : 2;"
FRBR_CASES = {
    "intact": 0, "no_x_gather": 1 | 4, "no_scores": 2,
    "no_scores_or_gather": 3, "no_dq_sums": 8,
    **{f"fr_rows_{u}": (0, [(FR_ROWS, FR_ROWS.replace("4 ? 4 : 2", v))])
       for u, v in ((2, "4 ? 2 : 1"), (8, "4 ? 8 : 4"))},
    **{f"fr_min_blocks_{m}": (0, [const("FR_MIN_BLOCKS", 4, m)])
       for m in (3, 5)},
    **{f"br_rows_{u}": (0, [const("BR_ROWS", 2, u)]) for u in (1, 4)},
    **{f"br_min_blocks_{m}": (0, [const("BR_MIN_BLOCKS", 6, m)])
       for m in (4, 5, 8)},
    "br_rows_4_min_blocks_4": (0, [const("BR_ROWS", 2, 4),
                                   const("BR_MIN_BLOCKS", 6, 4)])}
# the forward's segment lengths tried on the hub graph (the host's plan
# made to match; ROW_SPLIT intact)
FR_SEGS = (32, 64, 128, 256)

# the SDDMM's blocks an SM (spmm.cu's min_blocks, bf16 : f32)
SD_BLOCKS = "constexpr int min_blocks() { return sizeof(T) == 2 ? 8 : 6; }"
SD_CASES = {"intact": 0, "no_x_gather": 1,
            **{f"rows_{u}": (0, [const("SD_ROWS", 2, u)]) for u in (1, 4)},
            **{f"min_blocks_{b}": (0, [(SD_BLOCKS, SD_BLOCKS.replace(
                "8 : 6", b.replace("_", " : ")))])
               for b in ("6_4", "8_8")}}

# the beltrami_exp instances: no part switched off; each case sets
# flash's blocks an SM, then gmax's, named flash_<blocks>_gmax_<blocks>
# (intact: 5, 4)
BEL = ("fused_attention", "BEL_OFF", [], ("attention_score.cuh",))


def bel_case(blocks: int, gm_blocks: int):
    return (f"flash_{blocks}_gmax_{gm_blocks}",
            (0, [const("FLASH_MIN_BLOCKS", 5, blocks),
                 const("GM_MIN_BLOCKS", 4, gm_blocks)]))


BEL_CASES = {"intact": 0, **dict(bel_case(*c) for c in (
    (6, 2), (7, 6), (6, 8), (4, 3)))}
# the pin's beltrami_exp instance at 4, 5 and 6 (intact) blocks an SM
# (its BEL_MIN_BLOCKS), and the norm's at 3, 4 (intact) and 5
# (NM_BEL_MIN_BLOCKS); each constant sets that instance alone
PIN_BEL = ("attention_pin", "PIN_BEL_OFF", [], ())
PIN_BEL_CASES = {"intact": 0, **{
    f"pin_{m}": (0, [const("BEL_MIN_BLOCKS", 6, m)]) for m in (4, 5)}}
NORM_BEL = ("fused_attention", "NORM_BEL_OFF", [], ())
NORM_BEL_CASES = {"intact": 0, **{
    f"norm_{m}": (0, [const("NM_BEL_MIN_BLOCKS", 4, m)]) for m in (3, 5)}}

def substitute(text: str, subs, what: str) -> str:
    """``text`` with each (old, new) of ``subs`` replaced, each ``old``
    found exactly once."""
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{what}: the text to change moved: "
                               f"{old.splitlines()[0]!r}")
        text = text.replace(old, new)
    return text


def build(spec, cases) -> dict:
    """One library per case, from a guarded copy of the source (its
    headers copied in): the case's constants substituted, the flag set to
    the case's bits."""
    from graphax_torch.kernels import _build

    name, flag, guards, headers = spec
    text = open(os.path.join(_build.CSRC, name + ".cu")).read()
    for h in headers:   # in place of its first include, the others dropped
        inc = f'#include "{h}"'
        if inc not in text:
            raise RuntimeError(f"{name}: {inc} moved")
        head, _, tail = text.partition(inc)
        text = head + open(os.path.join(_build.CSRC, h)).read().replace(
            "#pragma once\n", "") + tail.replace(inc, "")
    text = substitute(text, guards, name + ".cu")

    def one(item):
        case, spec_ = item
        bits, subs = spec_ if isinstance(spec_, tuple) else (spec_, [])
        tag = "_".join(map(str, case)) if isinstance(case, tuple) else case
        src = os.path.join(OUT, f"{name}_{flag}_{tag}.cu")
        with open(src, "w") as f:
            f.write(substitute(text, subs, name).replace(
                '#include "', f'#include "{_build.CSRC}/'))
        so = os.path.join(OUT, f"lib{name}_{flag}_{tag}.so")
        proc = subprocess.run(
            [_build._nvcc(), _build.ARCH, "-Xptxas=-v", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", f"-D{flag}={bits}", "-o", so,
             src], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        with open(so[:-3] + ".ptxas.txt", "w") as f:
            f.write(proc.stdout + proc.stderr)
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
        return case, lib

    with ThreadPoolExecutor(len(cases)) as ex:
        return dict(ex.map(one, cases.items()))


def winatt_gmax() -> None:
    """The ``winatt_gmax`` group of the module's docstring."""
    import torch

    import chip_smoke as cs
    from graphax_torch import best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels import winatt as wa
    from graphax_torch.utils.params import linear_apply

    with ThreadPoolExecutor(2) as ex:
        k5 = ex.submit(build, WINATT, WINATT_CASES)
        gm = ex.submit(build, GMAX, GMAX_CASES)
        k5_libs, gm_libs = k5.result(), gm.result()
    s = _build.stream_ptr
    data = get_dataset("ogbn-arxiv")
    base = dict(block="constant", function="transformer")
    tr = cs.nl_trainer(best_config("ogbn-arxiv", **base), data)
    g, cfg, att = tr.data.graph, tr.cfg, tr.model.block.func.att
    csr = cs.nl_trainer(best_config("ogbn-arxiv", community_window=0,
                                    **base), data).data.graph.csr
    win, res = g.windows.in_window, g.windows.residual
    bf = torch.bfloat16
    with torch.no_grad():
        tr.model.eval()
        x = tr.model.encode(tr.data.x, train=False).to(bf).contiguous()
        q = linear_apply(att.Q, x).to(bf).contiguous()
        k = linear_apply(att.K, x).to(bf).contiguous()
        dk = cfg.attention_dim // cfg.heads
        q_s = (q / torch.sqrt(torch.tensor(dk, dtype=torch.float32)).to(bf)
               ).contiguous()
        kt = fa.attention_kproj(x, att.K.weight.t().to(bf).contiguous(),
                                att.K.bias.float().contiguous())
        scal = (cfg.attention_type, cfg.heads, 0.0, 0.0)
        r0 = fa.attention_gmax(res, q_s, kt, None, *scal)
        _, d_res = fa.attention_norm(res, q_s, kt, None, r0, *scal)
        want = wa.winatt_plain(win, q, k, x, d_res, r0, None, *scal)
    n, d = x.shape
    a, heads = q.shape[1], cfg.heads
    out = torch.empty(n, d, device="cuda")
    den = torch.empty(n, heads, device="cuda")

    def k5_args(lay, dr, rr, lanes):
        """gx_winatt's arguments on ``lay`` with the plan of its rows of
        more than ``lanes`` cells and its scratch (kept alive on the
        function)."""
        plan, nlong, nseg = fa._row_plan(lay, lanes, fa._BATCH)
        k5_args.keep = (torch.empty(nseg, 2 * heads, device="cuda"),
                        torch.empty(nseg, d, device="cuda"))
        return (lay.ptr.data_ptr(), lay.idx.data_ptr(), q.data_ptr(),
                k.data_ptr(), x.data_ptr(), None, dr.data_ptr(),
                rr.data_ptr(), plan.data_ptr(), k5_args.keep[0].data_ptr(),
                k5_args.keep[1].data_ptr(), out.data_ptr(), den.data_ptr(),
                n, d, a, heads, fa.ATT_TYPES[scal[0]], 0, 0.0, 0.0, 1,
                fa.gather_width(x), fa.score_vec(q, k, heads, scal[0]),
                nlong, nseg, s(x))

    for lanes in K5_LANES:
        args = k5_args(win, d_res, r0, lanes)
        row = dict(kernel="winatt", dtype="bfloat16", lanes=lanes,
                   cells=win.num_slots)
        for (case, g), lib in k5_libs.items():
            if g != lanes:
                continue
            _build.check(lib.gx_winatt(*args), case)
            torch.cuda.synchronize()
            if case == "intact":
                row["intact_max_abs_err"] = max(
                    float((out - want[0]).abs().max()),
                    float((den - want[1]).abs().max()))
            row[case + "_ms"] = cs.time_ms(lambda: lib.gx_winatt(*args))
        print(json.dumps(row), flush=True)
    # the long rows' walks: a windowed layout whose in-window rows reach
    # 512 cells, at the wrapper's lanes
    lg = cs.long_row_windows("cuda")
    lwin, lres = lg.windows.in_window, lg.windows.residual
    with torch.no_grad():
        lr0 = fa.attention_gmax(lres, q_s, kt, None, *scal)
        _, ld_res = fa.attention_norm(lres, q_s, kt, None, lr0, *scal)
    args = k5_args(lwin, ld_res, lr0, wa.LANES)
    row = dict(kernel="winatt", dtype="bfloat16", graph="long rows",
               lanes=wa.LANES, cells=lwin.num_slots)
    for case in ("intact", "no_x_gather", "no_score_loads",
                 "no_out_stores"):
        lib = k5_libs[case, wa.LANES]
        _build.check(lib.gx_winatt(*args), case)
        row[case + "_ms"] = cs.time_ms(lambda: lib.gx_winatt(*args))
    print(json.dumps(row), flush=True)
    with torch.no_grad():
        ops = fa.prep_inputs(tr.cfg, att, g, x)
    res_out = torch.empty((), device="cuda")
    state = torch.zeros(2, dtype=torch.int32, device="cuda")
    for label, lay, qq in (("windowed residual", res, q_s),
                           ("arxiv CSR", csr, ops["q"])):
        args = (lay.seg.data_ptr(), lay.idx.data_ptr(), qq.data_ptr(),
                kt.data_ptr(), None, state.data_ptr(), res_out.data_ptr(),
                lay.num_slots, a, heads, fa.ATT_TYPES[scal[0]], 0, 0.0, 0.0,
                1.0, 0.5, 1, fa.score_vec(qq, kt, heads, scal[0]), s(x))
        row = dict(kernel="attention_gmax", dtype="bfloat16", graph=label,
                   E=lay.num_slots)
        want = fa.attention_gmax_plain(lay, qq, kt, None, *scal)
        for case, lib in gm_libs.items():
            _build.check(lib.gx_attention_gmax(*args), case)
            torch.cuda.synchronize()
            if case == "intact":
                row["intact_abs_err"] = float((res_out - want).abs())
            row[case + "_ms"] = cs.time_ms(
                lambda: lib.gx_attention_gmax(*args))
        print(json.dumps(row), flush=True)


def bwd_cols_norm() -> None:
    """The ``bwd_cols_norm`` group of the module's docstring."""
    import torch

    import chip_smoke as cs
    from graphax_torch import best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa

    with ThreadPoolExecutor(2) as ex:
        b3 = ex.submit(build, B3, B3_CASES)
        nm = ex.submit(build, NORM, NORM_CASES)
        b3_libs, nm_libs = b3.result(), nm.result()
    s = _build.stream_ptr
    data = get_dataset("ogbn-arxiv")
    base = dict(block="constant", function="transformer")
    tr = cs.nl_trainer(best_config("ogbn-arxiv", community_window=0, **base),
                       data)
    tr_a = cs.nl_trainer(best_config("ogbn-arxiv", **base), data)
    g, cfg, att = tr.data.graph, tr.cfg, tr.model.block.func.att
    heads, bf = cfg.heads, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(12)
    with torch.no_grad():
        tr.model.eval()
        x = tr.model.encode(tr.data.x, train=False).to(bf).contiguous()
        n, d = x.shape
        c = torch.randn(n, d, generator=gen, device="cuda").to(bf)
        p = fa.prep_inputs(cfg, att, g, x)
        q = p["q"]
        kt = fa.attention_kproj(x, p["wk"], p["bk"])
        a = q.shape[1]
        _, sc, shift, denom = fa.attention_fwd_res(g.csr, q, x, kt, heads)
        _, rho = fa.attention_bwd_rows(g.csr, sc, shift, denom, c, x, kt,
                                       heads)
        want = fa.attention_bwd_cols_plain(g.csc, q, c, x, kt, shift, denom,
                                           rho, heads)
    hub = cs.hub_graph("cuda")
    for label, lay in (("arxiv CSC", g.csc), ("hub transposed", hub.csr)):
        plan, nlong, nseg = fa._row_plan(lay, fa._BATCH, fa._BATCH)
        pk = torch.empty(nseg, a, device="cuda")
        pv = torch.empty(nseg, d, device="cuda")
        dk = torch.empty(n, a, device="cuda")
        dxv = torch.empty(n, d, device="cuda")
        args = (lay.ptr.data_ptr(), lay.idx.data_ptr(), q.data_ptr(),
                c.data_ptr(), x.data_ptr(), kt.data_ptr(), shift.data_ptr(),
                denom.data_ptr(), rho.data_ptr(), plan.data_ptr(),
                pk.data_ptr(), pv.data_ptr(), dk.data_ptr(), dxv.data_ptr(),
                n, d, a, heads, 1, fa.gather_width(x),
                fa.score_vec(q, kt, heads, "scaled_dot"),
                fa.batch_warps(heads), nlong, nseg, s(x))
        row = dict(kernel="attention_bwd_cols", dtype="bfloat16",
                   graph=label, E=lay.num_slots)
        for case, lib in b3_libs.items():
            if label != "arxiv CSC" and case != "intact":
                continue
            _build.check(lib.gx_attention_bwd_cols(*args), case)
            torch.cuda.synchronize()
            if case == "intact" and label == "arxiv CSC":
                row["intact_max_abs_err"] = max(
                    float((dk - want[0]).abs().max()),
                    float((dxv - want[1]).abs().max()))
            row[case + "_ms"] = cs.time_ms(
                lambda: lib.gx_attention_bwd_cols(*args))
        print(json.dumps(row), flush=True)
    del hub, sc, shift, denom, rho, want
    # the norm on the windowed residual and the whole CSR
    with torch.no_grad():
        tr_a.model.eval()
        xa = tr_a.model.encode(tr_a.data.x, train=False).to(bf).contiguous()
        pa = fa.prep_inputs(tr_a.cfg, tr_a.model.block.func.att,
                            tr_a.data.graph, xa)
        kta = fa.attention_kproj(xa, pa["wk"], pa["bk"])
    scal = (cfg.attention_type, heads, 0.0, 0.0)
    for label, lay, qq, kk in (
            ("windowed residual", tr_a.data.graph.windows.residual, pa["q"],
             kta),
            ("arxiv CSR", g.csr, q, kt)):
        with torch.no_grad():
            gs = fa.attention_gmax(lay, qq, kk, None, *scal)
            want = fa.attention_norm_plain(lay, qq, kk, None, gs, *scal)
        e = torch.empty(lay.num_slots, heads, device="cuda")
        den = torch.empty(n, heads, device="cuda")
        row = dict(kernel="attention_norm", dtype="bfloat16", graph=label,
                   E=lay.num_slots)
        for case, lib in nm_libs.items():
            cut = NORM_CUTS.get(case, fa.NORM_CUT)
            plan, nlong, nseg = fa._row_plan(lay, cut, cut)
            part = torch.empty(nseg, heads, device="cuda")
            args = (lay.ptr.data_ptr(), lay.idx.data_ptr(), qq.data_ptr(),
                    kk.data_ptr(), None, gs.data_ptr(), plan.data_ptr(),
                    part.data_ptr(), e.data_ptr(), den.data_ptr(), n, a,
                    heads, fa.ATT_TYPES[scal[0]], 0, 0, 0.0, 0.0, 1.0, 0.5,
                    1, fa.score_vec(qq, kk, heads, scal[0]), nlong, nseg,
                    s(x))
            _build.check(lib.gx_attention_norm(*args), case)
            torch.cuda.synchronize()
            if case == "intact":
                row["intact_max_abs_err"] = max(
                    float((e - want[0]).abs().max()),
                    float((den - want[1]).abs().max()))
            row[case + "_ms"] = cs.time_ms(
                lambda: lib.gx_attention_norm(*args))
        print(json.dumps(row), flush=True)


def fwd_res_bwd_rows() -> None:
    """The ``fwd_res_bwd_rows`` group of the module's docstring."""
    import torch

    import chip_smoke as cs
    from graphax_torch import best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa

    libs = build(FRBR, FRBR_CASES)
    s = _build.stream_ptr
    data = get_dataset("ogbn-arxiv")
    tr = cs.nl_trainer(best_config("ogbn-arxiv", community_window=0,
                                   block="constant", function="transformer"),
                       data)
    g, cfg, att = tr.data.graph, tr.cfg, tr.model.block.func.att
    heads, bf = cfg.heads, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(12)
    with torch.no_grad():
        tr.model.eval()
        x = tr.model.encode(tr.data.x, train=False).to(bf).contiguous()
        n, d = x.shape
        c = torch.randn(n, d, generator=gen, device="cuda").to(bf)
        p = fa.prep_inputs(cfg, att, g, x)
        q = p["q"]
        kt = fa.attention_kproj(x, p["wk"], p["bk"])
    a = q.shape[1]
    kvec = fa.score_vec(q, kt, heads, "scaled_dot")
    hub = cs.hub_graph("cuda")
    for label, lay in (("arxiv CSR", g.csr), ("hub CSR", hub.csr)):
        with torch.no_grad():
            want = fa.attention_fwd_res_plain(lay, q, x, kt, heads)
            _, sc, shift, denom = want
            want_b = fa.attention_bwd_rows_plain(lay, sc, shift, denom, c, x,
                                                 kt, heads)
        got = [torch.empty_like(t) for t in want]
        dq, rho = torch.empty_like(kt), torch.empty_like(shift)
        fwd = dict(kernel="attention_fwd_res", dtype="bfloat16", graph=label,
                   E=lay.num_slots)
        bwd = dict(kernel="attention_bwd_rows", dtype="bfloat16",
                   graph=label, E=lay.num_slots)
        segs = FR_SEGS if label == "hub CSR" else (fa.ROW_SPLIT,)
        for case, lib in libs.items():
            if label != "arxiv CSR" and case != "intact":
                continue
            for seg in segs:
                plan, nlong, nseg = fa._row_plan(lay, fa._BATCH, seg)
                st = torch.empty(nseg, 2 * heads, device="cuda")
                part = torch.empty(nseg, d, device="cuda")
                fargs = (lay.ptr.data_ptr(), lay.idx.data_ptr(), q.data_ptr(),
                         x.data_ptr(), kt.data_ptr(), plan.data_ptr(),
                         st.data_ptr(), part.data_ptr(), got[1].data_ptr(),
                         got[2].data_ptr(), got[3].data_ptr(),
                         got[0].data_ptr(), n, d, a, heads, 1,
                         fa.gather_width(x), kvec, fa.flash_warps(a, heads),
                         seg, nlong, nseg, s(x))
                _build.check(lib.gx_attention_fwd_res(*fargs), case)
                torch.cuda.synchronize()
                tag = case if seg == fa.ROW_SPLIT else f"seg_{seg}"
                if case == "intact":
                    fwd[tag + "_max_abs_err"] = max(
                        float((u.float() - v.float()).abs().max())
                        for u, v in zip(got, want))
                fwd[tag + "_ms"] = cs.time_ms(
                    lambda: lib.gx_attention_fwd_res(*fargs))
            plan, nlong, nseg = fa._row_plan(lay, fa._BATCH, fa._BATCH)
            scratch = [torch.empty(nseg, k, device="cuda")
                       for k in (fa._BATCH, heads, a)]
            bargs = (lay.ptr.data_ptr(), lay.idx.data_ptr(), sc.data_ptr(),
                     shift.data_ptr(), denom.data_ptr(), c.data_ptr(),
                     x.data_ptr(), kt.data_ptr(), plan.data_ptr(),
                     *(t.data_ptr() for t in scratch), dq.data_ptr(),
                     rho.data_ptr(), n, d, a, heads, 1,
                     min(fa.gather_width(c), fa.gather_width(x)),
                     fa.batch_warps(heads), nlong, nseg, s(x))
            _build.check(lib.gx_attention_bwd_rows(*bargs), case)
            torch.cuda.synchronize()
            if case == "intact":
                bwd["intact_max_abs_err"] = max(
                    float((dq - want_b[0]).abs().max()),
                    float((rho - want_b[1]).abs().max()))
            bwd[case + "_ms"] = cs.time_ms(
                lambda: lib.gx_attention_bwd_rows(*bargs))
        print(json.dumps(fwd), flush=True)
        print(json.dumps(bwd), flush=True)


def sddmm() -> None:
    """The ``sddmm`` group of the module's docstring."""
    import torch

    import chip_smoke as cs
    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels import spmm as spmm_mod

    libs = build(SDDMM, SD_CASES)
    data = get_dataset("ogbn-arxiv")
    g0 = Trainer(best_config("ogbn-arxiv", community_window=0),
                 data).data.graph
    res = Trainer(best_config("ogbn-arxiv"), data).data.graph.windows.residual
    hub = cs.hub_graph("cuda")
    gen = torch.Generator(device="cuda").manual_seed(18)
    n, d = g0.num_nodes, 162
    for dt in (torch.bfloat16, torch.float32):
        g = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        x = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        for label, lay in (("arxiv CSR", g0.csr), ("windowed residual", res),
                           ("hub", hub.csr)):
            e = lay.num_slots
            plan, nlong, nseg = fa._row_plan(lay, fa._BATCH, fa._BATCH)
            out = torch.empty(e, device="cuda")
            args = (lay.ptr.data_ptr(), lay.idx.data_ptr(), g.data_ptr(),
                    x.data_ptr(), plan.data_ptr(), out.data_ptr(),
                    lay.num_rows, d, spmm_mod._DTYPES[dt],
                    min(fa.gather_width(g), fa.gather_width(x)), 0, nlong,
                    nseg, e, e, _build.stream_ptr(x))
            row = dict(kernel="sddmm", dtype=str(dt)[6:], graph=label, E=e)
            for case, lib in libs.items():
                _build.check(lib.gx_sddmm_csr(*args), case)
                torch.cuda.synchronize()
                if case == "intact":
                    want = spmm_mod.sddmm_plain(lay, g, x)
                    row["intact_max_abs_err"] = float(
                        (out - want).abs().max())
                row[case + "_ms"] = cs.time_ms(
                    lambda: lib.gx_sddmm_csr(*args))
            print(json.dumps(row), flush=True)
            del out
        del g, x
        torch.cuda.empty_cache()


def kproj_slab() -> None:
    """The ``kproj_slab`` group of the module's docstring."""
    import torch

    import chip_smoke as cs
    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels import windowed_spmm as ws

    kp_libs = build(KPROJ, KPROJ_CASES)
    slab_libs = build(SLAB, SLAB_CASES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    s = _build.stream_ptr
    for d in (162, 160):
        n, a = 169_343, 32
        x = torch.randn(n, d, generator=gen, device="cuda")
        wk = torch.randn(d, a, generator=gen, device="cuda") / d ** 0.5
        bk = 0.1 * torch.randn(a, generator=gen, device="cuda")
        want = fa.attention_kproj_plain(x, wk, bk)
        row = dict(kernel="attention_kproj", dtype="float32", N=n, D=d, A=a,
                   copy_bytes=fa.kproj_copy_bytes(x),
                   bound_ms=cs.bound_ms(4 * (n * d + d * a + a + n * a),
                                        2.0 * n * d * a, "float32")[0],
                   addmm_ms=cs.time_ms(lambda: torch.addmm(
                       bk, x, wk, out_dtype=torch.float32)),
                   x_clone_ms=cs.time_ms(lambda: x.clone()))
        for case, lib in kp_libs.items():
            kt = torch.empty(n, a, device="cuda")
            args = (x.data_ptr(), wk.data_ptr(), bk.data_ptr(), kt.data_ptr(),
                    n, d, a, 0, fa.kproj_copy_bytes(x),
                    fa.kproj_copy_bytes(wk), s(x))
            _build.check(lib.gx_attention_kproj(*args), case)
            torch.cuda.synchronize()
            if case == "intact":
                row["intact_max_abs_err"] = float((kt - want).abs().max())
            row[case + "_ms"] = cs.time_ms(
                lambda: lib.gx_attention_kproj(*args))
        print(json.dumps(row), flush=True)
        del x, wk, bk, want
    tr = Trainer(best_config("ogbn-arxiv"), get_dataset("ogbn-arxiv"))
    wl = tr.data.graph.windows
    n, d = wl.num_nodes, 162
    vals = torch.rand(tr.data.graph.edge_buffer_size, generator=gen,
                      device="cuda")
    dense = ws.densify(wl, vals, torch.bfloat16)
    g = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    want = ws.win_bwd_slab_plain(wl, dense, g, torch.bfloat16)
    cells = wl.num_tiles * wl.tile * wl.window
    row = dict(kernel="win_bwd_slab", dtype="bfloat16", out="bfloat16",
               bound_ms=cs.bound_ms(cells * 2 + 4 * n * d, 2.0 * cells * d,
                                    "bfloat16")[0],
               dense_clone_ms=cs.time_ms(lambda: dense.clone()))
    for case, lib in slab_libs.items():
        out = torch.empty(n, d, dtype=torch.bfloat16, device="cuda")
        args = (dense.data_ptr(), g.data_ptr(), wl.win_ptr.data_ptr(),
                wl.win_tiles.data_ptr(), out.data_ptr(), wl.num_windows,
                wl.tile, wl.window, n, d, 1, 1,
                int(ws.slab_staging(dense, g) == "cp.async"), 0, s(g))
        _build.check(lib.gx_win_bwd_slab(*args), case)
        torch.cuda.synchronize()
        if case == "intact":
            row["intact_max_abs_err"] = float(
                (out.float() - want.float()).abs().max())
        row[case + "_ms"] = cs.time_ms(lambda: lib.gx_win_bwd_slab(*args))
    print(json.dumps(row), flush=True)


def f32_core() -> None:
    """The ``f32_core`` group of the module's docstring."""
    import torch

    import chip_smoke as cs
    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import windowed_spmm as ws

    libs = build(F32, F32_CASES)
    tr = Trainer(best_config("ogbn-arxiv"), get_dataset("ogbn-arxiv"))
    wl = tr.data.graph.windows
    n, d, t_, tile, w = wl.num_nodes, 162, wl.num_tiles, wl.tile, wl.window
    cells = t_ * tile * w
    gen = torch.Generator(device="cuda").manual_seed(0)
    vals = torch.rand(tr.data.graph.edge_buffer_size, generator=gen,
                      device="cuda")
    dense = ws.densify(wl, vals, torch.float32)
    x, g, add = (torch.randn(n, d, generator=gen, device="cuda")
                 for _ in range(3))
    slab_g = ws._slab(x, wl)[wl.tile_win.long()].contiguous()
    g_t, add_t = ws._tiles(g, wl), ws._tiles(add, wl)
    s = _build.stream_ptr(x)
    flops = 2.0 * cells * d
    vb = ws.f32_copy_values(d, x, add)
    va_s, vb_s = ws.f32_copy_values(w, dense), ws.f32_copy_values(d, g)
    for kernel, od, nbytes, want, lib_ms, call in (
            ("win_matmul", torch.float32, cells * 4 + 3 * n * d * 4,
             lambda: ws.win_matmul_plain(wl, dense, x, add),
             lambda: torch.baddbmm(add_t, dense, slab_g),
             lambda lib, out: lib.gx_win_matmul(
                 dense.data_ptr(), x.data_ptr(), wl.tile_win.data_ptr(),
                 add.data_ptr(), out.data_ptr(), t_, tile, w, n, d, 0, 1, vb,
                 s)),
            *(("win_bwd_dense", od, 2 * n * d * 4 + cells * od.itemsize,
               lambda od=od: ws.win_bwd_dense_plain(wl, g, x, od),
               (lambda: torch.bmm(g_t, slab_g.transpose(1, 2)))
               if od == torch.float32 else None,
               lambda lib, out, od=od: lib.gx_win_bwd_dense(
                   g.data_ptr(), x.data_ptr(), wl.tile_win.data_ptr(),
                   out.data_ptr(), t_, tile, w, n, d, 0,
                   int(od == torch.bfloat16), 0, 0, s))
              for od in (torch.float32, torch.bfloat16)),
            ("win_bwd_slab", torch.float32, cells * 4 + 2 * n * d * 4,
             lambda: ws.win_bwd_slab_plain(wl, dense, g),
             None,
             lambda lib, out: lib.gx_win_bwd_slab(
                 dense.data_ptr(), g.data_ptr(), wl.win_ptr.data_ptr(),
                 wl.win_tiles.data_ptr(), out.data_ptr(), wl.num_windows,
                 tile, w, n, d, 0, 0, va_s, vb_s, s))):
        ref = want()
        row = dict(kernel=kernel, dtype="float32", out=str(od)[6:],
                   bound_ms=cs.bound_ms(nbytes, flops, "float32")[0],
                   library_ms=None if lib_ms is None
                   else cs.time_ms(lib_ms, reps=10))
        for case, lib in libs.items():
            out = torch.empty(ref.shape, dtype=od, device="cuda")
            _build.check(call(lib, out), f"{kernel} {case}")
            torch.cuda.synchronize()
            if case == "intact":
                row["intact_max_abs_err"] = float(
                    (out.float() - ref.float()).abs().max())
            row[case + "_ms"] = cs.time_ms(lambda: call(lib, out))
        print(json.dumps(row), flush=True)
        del ref


def beltrami() -> None:
    """The ``beltrami`` group of the module's docstring."""
    import torch

    import chip_smoke as cs
    from graphax_torch import get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_kernel_redesign as rd

    with ThreadPoolExecutor(3) as ex:
        jobs = [ex.submit(build, spec, cases) for spec, cases in (
            (BEL, BEL_CASES), (PIN_BEL, PIN_BEL_CASES),
            (NORM_BEL, NORM_BEL_CASES))]
        libs, libs_pin, libs_norm = (j.result() for j in jobs)
    beltrami_pin_norm(libs_pin, libs_norm)
    dts = (torch.bfloat16, torch.float32)
    tr, ops = rd.blend_operands(get_dataset("ogbn-arxiv"), dts)
    g = tr.data.graph
    hub = cs.hub_graph("cuda")
    for dt in dts:
        o = ops[dt]
        q, x, kt, scal, bel = o["q"], o["x"], o["kt"], o["scal"], o["bel"]
        heads = scal[1]
        name = str(dt)[6:]
        graphs = [("arxiv CSR", g.csr, x), ("hub", hub.csr, x)]
        if dt == torch.bfloat16:
            graphs.append(("arxiv CSR, D 164", g.csr,
                           torch.cat([x, x[:, :2]], 1)))
        for label, lay, xg in graphs:
            with torch.no_grad():
                want = fa.flash_attention_plain(lay, q, xg, kt, None, None,
                                                *scal, **bel)
            out = torch.empty_like(want)
            kvec = fa.flash_kvec(kt, heads, scal[0])
            row = dict(kernel="flash_attention", att_type=scal[0],
                       dtype=name, graph=label, E=lay.num_slots, kvec=kvec,
                       D=xg.shape[1], vec_bytes=fa.gather_width(xg))
            ref = None
            for case, lib in libs.items():
                for route, kv in (("", kvec), ("_one_value", 0)):
                    def call(lib=lib, kv=kv, xg=xg):
                        return rd.flash_call(lib.gx_flash_attention, lay, q,
                                             xg, kt, None, scal, bel, out, kv)
                    _build.check(call(), case)
                    torch.cuda.synchronize()
                    if ref is None:
                        ref = out.clone()
                        row["intact_max_abs_err"] = float(
                            (out - want).abs().max())
                    row[case + route + "_equal"] = bool(torch.equal(out, ref))
                    row[case + route + "_ms"] = cs.time_ms(call)
            print(json.dumps(row), flush=True)
        lay = g.csr
        qvec = fa.score_vec(q, kt, heads, scal[0])
        want = fa.attention_gmax_plain(lay, q, kt, None, *scal, **bel)
        out = torch.empty((), device="cuda")
        state = torch.zeros(2, dtype=torch.int32, device="cuda")
        row = dict(kernel="attention_gmax", att_type=scal[0], dtype=name,
                   graph="arxiv CSR", E=lay.num_slots, qvec=qvec,
                   intact_abs_err=None)
        for case, lib in libs.items():
            for route, qv in (("", qvec), ("_one_value", 0)):
                def call(lib=lib, qv=qv):
                    return lib.gx_attention_gmax(
                        lay.seg.data_ptr(), lay.idx.data_ptr(), q.data_ptr(),
                        kt.data_ptr(), None, state.data_ptr(),
                        out.data_ptr(), lay.num_slots, q.shape[1], heads,
                        fa.ATT_TYPES[scal[0]], 0, scal[2], scal[3],
                        bel["ov2p"], bel["inv2l2p"], fa._DTYPES[dt], qv,
                        _build.stream_ptr(q))
                _build.check(call(), case)
                torch.cuda.synchronize()
                if row["intact_abs_err"] is None:
                    row["intact_abs_err"] = float((out - want).abs())
                    row["value"] = float(out)
                row[case + route + "_equal"] = float(out) == row["value"]
                row[case + route + "_ms"] = cs.time_ms(call)
        print(json.dumps(row), flush=True)


def beltrami_pin_norm(libs_pin, libs_norm) -> None:
    """The pin's and the norm's cases of the ``beltrami`` group."""
    import torch

    import chip_smoke as cs
    from graphax_torch import get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import attention_pin as pin_mod
    from graphax_torch.kernels import fused_attention as fa

    import torch_kernel_redesign as rd

    dts = (torch.bfloat16, torch.float32)
    tr, ops = rd.blend_operands(get_dataset("ogbn-arxiv"), dts)
    g = tr.data.graph
    hub = cs.hub_graph("cuda")
    knn = rd.regular_graph("cuda")
    for dt in dts:
        o = ops[dt]
        q, x, kt, scal, bel = o["q"], o["x"], o["kt"], o["scal"], o["bel"]
        heads, a = scal[1], q.shape[1]
        name = str(dt)[6:]
        kvec = fa.flash_kvec(kt, heads, scal[0])
        wpb = fa.flash_warps(a, heads, scal[0])
        for label, lay in (("arxiv CSR", g.csr), ("hub", hub.csr),
                           ("64-regular", knn.csr)):
            with torch.no_grad():
                want = pin_mod.attention_pin_plain(lay, q, x, o["wk"],
                                                   o["bk"], None, *scal,
                                                   **bel)
            out = torch.empty_like(want)
            row = dict(kernel="attention_pin", att_type=scal[0], dtype=name,
                       graph=label, E=lay.num_slots, kvec=kvec)
            ref = None
            for case, lib in libs_pin.items():
                for route, kv in (("", kvec), ("_one_value", 0)):
                    def call(lib=lib, kv=kv, lay=lay):
                        return rd.pin_call(lib.gx_attention_pin, lay, q, kt,
                                           None, scal, bel, out, kv, wpb)
                    _build.check(call(), case)
                    torch.cuda.synchronize()
                    if ref is None:
                        ref = out.clone()
                        row["intact_max_abs_err"] = float(
                            (out - want).abs().max())
                    row[case + route + "_equal"] = bool(torch.equal(out, ref))
                    row[case + route + "_ms"] = cs.time_ms(call)
            print(json.dumps(row), flush=True)
        qvec = fa.score_vec(q, kt, heads, scal[0])
        for label, lay in (("arxiv CSR", g.csr), ("hub", hub.csr)):
            with torch.no_grad():
                gs = fa.attention_gmax(lay, q, kt, None, *scal, **bel)
                want = fa.attention_norm_plain(lay, q, kt, None, gs, *scal,
                                               **bel)
            e = torch.empty_like(want[0])
            den = torch.empty_like(want[1])
            row = dict(kernel="attention_norm", att_type=scal[0], dtype=name,
                       graph=label, E=lay.num_slots, qvec=qvec)
            ref = None
            for case, lib in libs_norm.items():
                for route, qv in (("", qvec), ("_one_value", 0)):
                    def call(lib=lib, qv=qv, lay=lay):
                        return rd.norm_call(lib.gx_attention_norm, lay, q,
                                            kt, gs, scal, bel, e, den, False,
                                            qv)
                    _build.check(call(), case)
                    torch.cuda.synchronize()
                    if ref is None:
                        ref = (e.clone(), den.clone())
                        row["intact_max_abs_err"] = max(
                            float((e - want[0]).abs().max()),
                            float((den - want[1]).abs().max()))
                    row[case + route + "_equal"] = bool(
                        torch.equal(e, ref[0]) and torch.equal(den, ref[1]))
                    row[case + route + "_ms"] = cs.time_ms(call)
            print(json.dumps(row), flush=True)


# the other score types' kernels after the first-form beltrami_exp helper
# (a __noinline__ call in score()) left the source: score() made a call
# again (its type-0 to type-3 arithmetic not inlined), and flash_seg_sum's
# instances other than beltrami_exp's held to 4 blocks an SM (64
# registers), each alone and together
SCORE_CALL = ("__device__ __forceinline__ float score(const Q* q, "
              "const float* k, int dk,",
              "__device__ __noinline__ float score(const Q* q, "
              "const float* k, int dk,")
SEG_SUM_4 = ("__global__ void __launch_bounds__(WPB * 32)\nflash_seg_sum(",
             "__global__ void __launch_bounds__(WPB * 32, BEL ? 1 : 4)\n"
             "flash_seg_sum(")
SC_FA = ("fused_attention", "SC_OFF", [], ("attention_score.cuh",))
SC_FA_CASES = {"intact": 0, "seg_sum_4": (0, [SEG_SUM_4]),
               "score_call": (0, [SCORE_CALL]),
               "score_call_seg_sum_4": (0, [SCORE_CALL, SEG_SUM_4])}
SC_PIN = ("attention_pin", "SC_OFF", [], ("attention_score.cuh",))
SC_PIN_CASES = {"intact": 0, "score_call": (0, [SCORE_CALL])}


def kernel_us(call, reps: int = 10) -> dict:
    """Device microseconds a launch of each kernel ``call()`` runs, by
    name (its template arguments dropped), from torch.profiler over
    ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split()[-1]
            name = name.split("::")[-1]
            out[name] = out.get(name, 0.0) + t / reps
    return out


def scoring(parent=None) -> None:
    """The ``scoring`` group of the module's docstring."""
    import torch

    import chip_smoke as cs
    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_kernel_redesign as rd

    with ThreadPoolExecutor(2) as ex:
        fa_job = ex.submit(build, SC_FA, SC_FA_CASES)
        pin_job = ex.submit(build, SC_PIN, SC_PIN_CASES)
        libs_fa, libs_pin = fa_job.result(), pin_job.result()
    if parent is not None:   # the tree before the helper's deletion
        libs_fa["parent"] = rd.parent_library(parent, "fused_attention")
        libs_pin["parent"] = rd.parent_library(parent, "attention_pin")
    g = Trainer(best_config("ogbn-arxiv", community_window=0),
                get_dataset("ogbn-arxiv")).data.graph
    graphs = (("arxiv CSR", g.csr), ("hub", cs.hub_graph("cuda").csr),
              ("pareto", rd.pareto_graph("cuda").csr))
    n, d, a, heads = g.num_nodes, 162, 32, 2
    gen = torch.Generator(device="cuda").manual_seed(23)
    x32 = torch.randn(n, d, generator=gen, device="cuda")
    q32 = 0.3 * torch.randn(n, a, generator=gen, device="cuda")
    wk32 = 0.3 / d ** 0.5 * torch.randn(d, a, generator=gen, device="cuda")
    bk = 0.1 * torch.randn(a, generator=gen, device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        x, q, wk = x32.to(dt), q32.to(dt), wk32.to(dt)
        kt = fa.attention_kproj(x, wk, bk)
        types = ("scaled_dot", "cosine_sim", "exp_kernel") \
            if dt == torch.bfloat16 else ("scaled_dot",)
        for att_type in types:
            scal = (att_type, heads, 1.3, 0.7)
            for label, lay in graphs:
                gs = fa.attention_gmax(lay, q, kt, None, *scal)
                for variant, shift in (("softmax", None),
                                       ("squareplus", gs)):
                    out = torch.empty(n, d, device="cuda")
                    row = dict(kernel="flash_attention", att_type=att_type,
                               dtype=str(dt)[6:], graph=label,
                               variant=variant)
                    ref = None
                    for case, lib in libs_fa.items():
                        def call(lib=lib, lay=lay, shift=shift):
                            return rd.flash_call(lib.gx_flash_attention, lay,
                                                 q, x, kt, shift, scal, {},
                                                 out)
                        _build.check(call(), case)
                        torch.cuda.synchronize()
                        ref = out.clone() if ref is None else ref
                        row[case + "_equal"] = bool(torch.equal(out, ref))
                        row[case + "_ms"] = cs.time_ms(call)
                        if label != "arxiv CSR":
                            row[case + "_kernels_us"] = kernel_us(call)
                    print(json.dumps(row), flush=True)
                pout = torch.empty(lay.num_slots, device="cuda")
                row = dict(kernel="attention_pin", att_type=att_type,
                           dtype=str(dt)[6:], graph=label)
                ref = None
                for case, lib in libs_pin.items():
                    def call(lib=lib, lay=lay):
                        return rd.pin_call(
                            lib.gx_attention_pin, lay, q, kt, None, scal, {},
                            pout, fa.flash_kvec(kt, heads, att_type),
                            fa.flash_warps(a, heads))
                    _build.check(call(), case)
                    torch.cuda.synchronize()
                    ref = pout.clone() if ref is None else ref
                    row[case + "_equal"] = bool(torch.equal(pout, ref))
                    row[case + "_ms"] = cs.time_ms(call)
                    if label != "arxiv CSR":
                        row[case + "_kernels_us"] = kernel_us(call)
                print(json.dumps(row), flush=True)


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("winatt_gmax", "kproj_slab",
                                       "bwd_cols_norm", "fwd_res_bwd_rows",
                                       "f32_core", "sddmm", "beltrami",
                                       "scoring"),
                    default=None, help="one group of ablations")
    ap.add_argument("--parent", default=None,
                    help="scoring: a parent checkout whose kernels run "
                    "beside the builds on the same inputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from graphax_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    _build.build_all()
    if args.only in (None, "winatt_gmax"):
        winatt_gmax()
    if args.only in (None, "kproj_slab"):
        kproj_slab()
    if args.only in (None, "bwd_cols_norm"):
        bwd_cols_norm()
    if args.only in (None, "fwd_res_bwd_rows"):
        fwd_res_bwd_rows()
    if args.only in (None, "f32_core"):
        f32_core()
    if args.only in (None, "sddmm"):
        sddmm()
    if args.only in (None, "beltrami"):
        beltrami()
    if args.only in (None, "scoring"):
        scoring(None if args.parent is None
                else os.path.abspath(args.parent))
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
