"""``python -m bjxa_tpu_torch`` — the bjxa CLI."""

import sys

from bjxa_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main(["bjxa"] + sys.argv[1:]))
