"""Three-term roofline model from dry-run records, on one NVIDIA H100.

Counterpart of ``repro.utils.roofline``, with the same report and formula;
the constants are the H100's, from NVIDIA's datasheet (H100 SXM5 80 GB at
its 700 W limit, dense rates without sparsity). They are datasheet
figures, not measurements:

  peak compute  989 TFLOP/s bf16 per GPU
  HBM bandwidth 3.35 TB/s per GPU
  link          50 GB/s per GPU: one 400 Gb/s NDR InfiniBand port per GPU,
                as in a DGX H100. A 16-wide mesh axis spans two 8-GPU NVLink
                domains, so its slowest link, the inter-node one, sets the
                collective term. Inside a node NVLink 4 gives 450 GB/s per
                direction per GPU.

Terms (all per GPU, because the dry run counts rank 0's own shards):
  compute    = flops_per_device / peak
  memory     = bytes_per_device / hbm_bw
  collective = collective_bytes_per_device / link_bw
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

PEAK_FLOPS = 989e12  # bf16 / GPU, dense
HBM_BW = 3.35e12  # bytes/s / GPU
LINK_BW = 50e9  # bytes/s / GPU, inter-node (one 400 Gb/s NDR port)


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    kind: str  # train | prefill | decode
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float  # 6*N*D (dense) or 6*N_active*D (MoE), global
    n_devices: int
    peak_memory_per_device: Optional[float] = None
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)
    notes: str = ""

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """No-overlap lower bound: the max term (perfect overlap of others)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): the remat/recompute/waste detector."""
        counted_global = self.flops_per_device * self.n_devices
        return self.model_flops / counted_global if counted_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """How close the step would run to the compute roofline if it achieved
        the no-overlap lower bound: useful-compute-time / bound."""
        t_useful = (self.model_flops / self.n_devices) / PEAK_FLOPS
        lb = self.step_time_lower_bound
        return t_useful / lb if lb else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(
            t_compute=self.t_compute,
            t_memory=self.t_memory,
            t_collective=self.t_collective,
            bottleneck=self.bottleneck,
            useful_flops_fraction=self.useful_flops_fraction,
            roofline_fraction=self.roofline_fraction,
        )
        return d


def model_flops(cfg, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """6*N*D (training) / 2*N*D (inference fwd) with N = active params."""
    n = getattr(cfg, "n_active_params", None) or cfg.n_params
    tokens = seq_len * global_batch
    if shape_kind == "train":
        return 6.0 * n * tokens
    if shape_kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * global_batch  # decode: one token per sequence
