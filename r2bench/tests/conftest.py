"""The benchmark's own tests: ``python -m pytest r2bench/tests`` from the root
of the checkout (the card-only cases carry ``requires_cuda``)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
