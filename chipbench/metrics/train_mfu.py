"""Model FLOPs of the window's training steps (6 N T with attention, no
recomputation; ``harness.flops``) over the window's seconds, as a share of
the H100's 989 TFLOP/s bf16 peak."""

from harness.flops import PEAK_BF16_FLOPS


def read(record, profile):
    if record["kind"] != "train":
        return None
    return record["model_flops"] / record["window_s"] / PEAK_BF16_FLOPS * 100
