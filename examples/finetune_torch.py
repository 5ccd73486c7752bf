"""End-to-end training on the PyTorch port: the launcher's whole stack.

Counterpart of ``finetune.py``: trains an LM (the reduced config by
default) through the train step, the deterministic data pipeline, async
checkpointing and the fault-tolerant supervisor, and checks that the loss
falls. Runs on the card unless ``--device cpu``. With ``--model-parallel``
above 1, or under ``torchrun``, it steps through the sharded train step on
a (data, model) mesh over every rank:

    PYTHONPATH=src python examples/finetune_torch.py --steps 200 --device cpu
    PYTHONPATH=src python examples/finetune_torch.py --arch smollm-135m --full \\
        --steps 300 --batch 8 --seq 256        # the ~135M-parameter run, on the card
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/finetune_torch.py \\
        --model-parallel 2 --device cpu --steps 40
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import train as train_mod  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true",
                    help="use the full config instead of the reduced one")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_example_torch")
    args = ap.parse_args(argv)

    launch = ["--arch", args.arch, "--steps", str(args.steps), "--batch", str(args.batch),
              "--seq", str(args.seq), "--model-parallel", str(args.model_parallel),
              "--device", args.device, "--ckpt-dir", args.ckpt_dir]
    if not args.full:
        launch.append("--smoke")
    result = train_mod.main(launch)
    assert result["last_loss"] < result["first_loss"], "loss did not decrease"
    if os.environ.get("RANK", "0") == "0":
        print(f"\nloss {result['first_loss']:.3f} -> {result['last_loss']:.3f} "
              f"over {result['steps']} steps ({result['steps_per_s']:.2f} steps/s)")
    return result


if __name__ == "__main__":
    main()
