"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the repository's root (no card needed)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
