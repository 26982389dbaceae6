"""The benchmark's CPU tests import ``benchmark.*`` from the checkout's
root, and run the program on the CPU at small sizes."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
