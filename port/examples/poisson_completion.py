"""Generalized-loss completion on the port: fit a count tensor under the
Poisson loss with Adam — the same sparse kernels, a new objective. On the
card unless ``--device cpu``.

    python port/examples/poisson_completion.py [--device cpu]
        [--dims 60,50,40] [--nnz 20000] [--iters 120]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

from repro_torch.core import losses as L  # noqa: E402
from repro_torch.core.completion import gcp_adam_init, gcp_step  # noqa
from repro_torch.core.completion.gcp import gcp_loss  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dims", default="60,50,40")
    ap.add_argument("--nnz", type=int, default=20_000)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.dims.split(","))
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    base = synthetic.function_tensor(shape, args.nnz, gen)
    counts = base.with_values(
        torch.poisson(5.0 * base.values, generator=gen).float())

    R = args.rank
    fs = [torch.randn(s, R, generator=gen, device=args.device).abs() * 0.3
          + 0.05 for s in shape]
    ad = gcp_adam_init(fs)
    losses = []
    for it in range(args.iters):
        fs, ad = gcp_step(counts, fs, L.poisson, 1e-7, 5e-3, ad)
        if it % 20 == 0:
            loss = float(gcp_loss(counts, fs, L.poisson, 1e-7))
            losses.append(loss)
            print(f"iter {it:3d} poisson loss {loss:.1f}")
    final = float(gcp_loss(counts, fs, L.poisson, 1e-7))
    print("final loss:", final)
    return losses + [final]


if __name__ == "__main__":
    main()
