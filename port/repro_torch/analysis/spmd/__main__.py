import sys

from repro_torch.analysis.spmd.cli import main

if __name__ == "__main__":
    sys.exit(main())
