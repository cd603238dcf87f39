"""Paper Fig. 7a (scaled) on the port: ALS against CCD++ against SGD on
the function-tensor model problem, with fault-tolerant checkpointing, each
through ``repro_torch.launch.complete`` (the CLI's ``main``) on the card
unless ``--device cpu``.

    python port/examples/function_tensor_als.py [--device cpu]
        [--dims 120,110,100] [--nnz 120000] [--sweeps 6] [--ckpt-root DIR]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from repro_torch.launch import complete  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dims", default="120,110,100")
    ap.add_argument("--nnz", type=int, default=120_000)
    ap.add_argument("--rank", type=int, default=10)
    ap.add_argument("--sweeps", type=int, default=6)
    ap.add_argument("--ckpt-root", default=None,
                    help="checkpoints go to DIR/<algorithm> (default: a "
                         "temporary directory, removed after)")
    args = ap.parse_args(argv)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = args.ckpt_root or tmp
        for algo in ("als", "ccd_tttp", "sgd"):
            print(f"=== {algo} ===", flush=True)
            runs[algo] = complete.main([
                "--dataset", "function", "--algorithm", algo,
                "--dims", args.dims, "--nnz", str(args.nnz),
                "--rank", str(args.rank), "--sweeps", str(args.sweeps),
                "--device", args.device,
                "--ckpt-dir", os.path.join(root, algo)])
    return runs


if __name__ == "__main__":
    main()
