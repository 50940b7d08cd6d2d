"""`python -m pls_tpu_torch` → the reference-compatible CLI (see cli.py)."""

import sys

from pls_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
