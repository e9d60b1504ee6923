"""The column route's denominators on the card: ``index_add_`` against the
segment reduce that `graphax_torch.kernels.attention3.column_denominators`
uses.

Prints, on an NVIDIA GPU:

1. the card's name and power limit;
2. the sum of three f32 subnormals by each reduce on the card and by
   ``index_add_`` on the CPU (an f32 atomic add flushes subnormals to zero);
3. chip_smoke's card-against-CPU reference of the GRAND-nl routes
   (`phase_reference_nl_routes`: the column softmax trained one step
   through the rk4 adjoint) with each reduce in `column_denominators`;
4. both reduces' agreement and median ms (CUDA events, 20 launches) at
   ogbn-arxiv's column count and edge count, two heads.

Run from the root of the repo: ``python3 scripts/torch_colnorm_reduce.py``.
"""

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from graphax_torch.kernels import attention3 as a3  # noqa: E402
from graphax_torch.sparse.ops import segment_sum  # noqa: E402


def index_add_denominators(csc, e):
    return segment_sum(e[csc.perm], csc.seg, csc.num_rows)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(cs.smi_line())
    dev = "cuda"
    v = torch.tensor([[1e-40], [2e-40], [3e-39]])
    ids = torch.zeros(3, dtype=torch.long)
    print(json.dumps({
        "subnormal_sum": {
            "index_add_cuda": torch.zeros(1, 1, device=dev).index_add_(
                0, ids.to(dev), v.to(dev)).item(),
            "segment_reduce_cuda": torch.segment_reduce(
                v.to(dev), "sum", offsets=torch.tensor([0, 3], device=dev),
                axis=0).item(),
            "index_add_cpu": torch.zeros(1, 1).index_add_(0, ids, v).item()}}))

    new = a3.column_denominators
    for name, fn in (("index_add_", index_add_denominators),
                     ("segment_reduce", new)):
        a3.column_denominators = fn
        t = time.time()
        try:
            out = {"passed": True, **cs.phase_reference_nl_routes()}
        except cs.Failed as ex:
            out = {"passed": False, "failure": str(ex)}
        print(json.dumps({"reduce": name, "s": time.time() - t, **out},
                         default=str))
    a3.column_denominators = new

    e_count, n, heads = 1354429, 169343, 2
    gen = torch.Generator().manual_seed(0)
    col = torch.randint(0, n, (e_count,), generator=gen)
    perm = torch.argsort(col, stable=True).to(dev)
    ptr = torch.zeros(n + 1, dtype=torch.long)
    ptr[1:] = torch.cumsum(torch.bincount(col, minlength=n), 0)
    ptr, seg = ptr.to(dev), col.to(dev)[perm]
    e = torch.rand(e_count, heads, device=dev)

    def by_index_add():
        return segment_sum(e[perm], seg, n)

    def by_segment_reduce():
        return torch.segment_reduce(e[perm], "sum", offsets=ptr, axis=0)

    print(json.dumps({
        "arxiv_size_max_abs_diff": float(
            (by_index_add() - by_segment_reduce()).abs().max()),
        "index_add_ms": cs.time_ms(by_index_add),
        "segment_reduce_ms": cs.time_ms(by_segment_reduce)}))


if __name__ == "__main__":
    main()
