"""Quickstart on the port: the paper's workflow end to end through
``repro_torch``, on the card unless ``--device cpu``.

    python port/examples/quickstart.py [--device cpu] [--dims 80,70,60]
        [--nnz 30000] [--rank 8] [--sweeps 10]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

import repro_torch.core.api as ctf  # noqa: E402  (Cyclops-style facade)
from repro_torch.core.completion import als_sweep  # noqa: E402
from repro_torch.core.tttp import cp_residual_norm  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dims", default="80,70,60")
    ap.add_argument("--nnz", type=int, default=30_000)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.dims.split(","))
    gen = torch.Generator(device=args.device).manual_seed(args.seed)

    # 1. a sparse observed tensor (Karlsson function-tensor model problem)
    T = synthetic.function_tensor(shape, args.nnz, gen)
    Omega = T.with_values(torch.ones_like(T.values))
    cells = 1
    for s in shape:
        cells *= s
    print(f"tensor {T.shape}, nnz={T.nnz}, density={T.nnz / cells:.3%}")

    # 2. the paper's kernels through the high-level API (Listings 2-3)
    R = args.rank
    U, V, W = (torch.randn(s, R, generator=gen, device=args.device) / R ** 0.5
               for s in shape)
    S = ctf.TTTP(T, [U, V, W])                      # sparse ⊙ CP model
    y = ctf.einsum("ijk,jr,kr->ir", T, V, W)        # MTTKRP
    print("TTTP nnz-values:", S.values[:3].tolist(),
          "\nMTTKRP row0:", y[0, :4].tolist())

    # 3. tensor completion by ALS with implicit batched CG (paper §2.2)
    fs = [U, V, W]
    errs = []
    for it in range(args.sweeps):
        fs = als_sweep(T, Omega, fs, 1e-6, cg_iters=R + 4)
        err = float(cp_residual_norm(T, fs) / T.norm())
        errs.append(err)
        print(f"sweep {it:2d}: relative residual {err:.5f}")
    print("done — see port/examples/function_tensor_als.py for the full "
          "driver")
    return errs


if __name__ == "__main__":
    main()
