"""Test settings of the benchmark's own tests (``pytest chipbench``).

They are not collected by the repository's suite (``testpaths = tests``).
Tests that need a CUDA card carry the ``card`` marker and skip without
one; each decides inside the test, never while the module is imported.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
