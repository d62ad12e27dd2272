"""``python -m repro_torch.analysis``: run the hot-path static analyzer
(``cli.py``)."""
import sys

from repro_torch.analysis.cli import run_cli

if __name__ == "__main__":
    sys.exit(run_cli())
