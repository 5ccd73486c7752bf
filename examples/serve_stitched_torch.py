"""Serving on the PyTorch port with the stitched KV arena: continuous
batching + live memory accounting + allocator comparison on the engine's
real trace.

Counterpart of ``serve_stitched.py``: the port's serve launcher on
smollm-135m's smoke config. Runs on the card unless ``--device cpu``:

    PYTHONPATH=src python examples/serve_stitched_torch.py --requests 16 [--device cpu]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch import serve as serve_mod  # noqa: E402

if __name__ == "__main__":
    serve_mod.main(["--arch", "smollm-135m", "--smoke"] + sys.argv[1:])
