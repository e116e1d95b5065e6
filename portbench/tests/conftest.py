"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the checkout. They run on the CPU through the port's plain
paths and print no device metric."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
