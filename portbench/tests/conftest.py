"""The benchmark's CPU tests import its modules by their names under
portbench/ (pb, recipes, reference, metrics, roofline), as run.py does."""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)
