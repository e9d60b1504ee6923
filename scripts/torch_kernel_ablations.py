"""Where the time of the two kernels redesigned last goes, on the card: the
CUDA-core ``attention_kproj`` (f32) and bf16 ``win_bwd_slab``, each built
again from this checkout's source with parts of its loop switched off, and
timed beside the intact kernel at the ogbn-arxiv preset's shapes.

- ``kproj_kernel`` at the arxiv widths (N 169,343, D 162, A 32: 8-byte
  copies of x) and at D 160 (16-byte copies): intact; without its FMAs
  (the staging alone); without its staging (the FMAs on whatever the
  ring holds); beside ``addmm(out_dtype=float32)`` and ``x.clone()``
  (x read and written once).
- ``win_bwd_slab_tc_kernel`` (bf16 blocks and g, bf16 output) on the
  windowed arxiv layout: intact; without the blocks' staging; without
  g's (its 4-byte copies); without the MMAs; with only the loop's
  barriers and the stores left.

A switched-off part leaves the results wrong: only the intact builds are
checked (against the plain versions). Each ablated build is a copy of the
source with guards on the switched-off statements, compiled by ``nvcc``
into ``results/ablations/`` (ignored by git) and called through the same C
interface as the port. One JSON line per measurement (device ms as
chip_smoke's ``time_ms`` takes them), then the card's nvidia-smi line. Run
from the root of the repo on the card:
``python3 scripts/torch_kernel_ablations.py``.
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

# (source, flag, [(statement, guarded statement)]): the guard drops the
# statement where the flag's bit is set
KPROJ = ("fused_attention", "KPROJ_OFF", [
    ("      kc_stage_rows<T, KC_BM, KC_BK>(",
     "      if (!(KPROJ_OFF & 2)) kc_stage_rows<T, KC_BM, KC_BK>("),
    ("      kc_stage_rows<T, KC_BK, BN>(",
     "      if (!(KPROJ_OFF & 2)) kc_stage_rows<T, KC_BK, BN>("),
    ("      if (k < kend) {  // columns past D are zeros on both sides",
     "      if (!(KPROJ_OFF & 1) && k < kend) {"),
])
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
])
# the parts switched off: bit 1 the products, 2 (and 4) the staging
KPROJ_CASES = {"intact": 0, "no_fma": 1, "no_staging": 2}
SLAB_CASES = {"intact": 0, "no_mma": 1, "no_block_staging": 2,
              "no_g_staging": 4, "barriers_and_stores": 7}


def build(spec, cases) -> dict:
    """One library per case, from a guarded copy of the source."""
    from graphax_torch.kernels import _build

    name, flag, guards = spec
    text = open(os.path.join(_build.CSRC, name + ".cu")).read()
    for old, new in guards:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}.cu: the statement to guard moved: "
                               f"{old.splitlines()[0]!r}")
        text = text.replace(old, new)
    src = os.path.join(OUT, name + "_ablated.cu")
    with open(src, "w") as f:
        f.write(text.replace('#include "', f'#include "{_build.CSRC}/'))

    def one(item):
        case, bits = item
        so = os.path.join(OUT, f"lib{name}_{case}.so")
        proc = subprocess.run(
            [_build._nvcc(), _build.ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", f"-D{flag}={bits}", "-o", so, src],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
        return case, lib

    with ThreadPoolExecutor(len(cases)) as ex:
        return dict(ex.map(one, cases.items()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from graphax_torch import Trainer, best_config, get_dataset
    from graphax_torch.kernels import _build
    from graphax_torch.kernels import fused_attention as fa
    from graphax_torch.kernels import windowed_spmm as ws

    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    _build.build_all()
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
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
