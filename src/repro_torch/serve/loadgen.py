"""Synthetic million-user serving load (the north star's traffic leg).

Generates deterministic multi-tenant request schedules: a seeded diurnal
arrival process (sinusoidal base rate + Poisson draws), superimposed
bursts (product launches, retry storms), a long-tailed million-user id
space, and per-tenant SLO classes with distinct prompt/decode mixes:

  * ``interactive`` — chat: short prompts, short decodes, tight TTFT/TPOT
  * ``standard``    — API traffic: medium prompts/decodes
  * ``batch``       — offline summarization: long prompts, long decodes,
                      loose deadlines

Everything is a pure function of ``LoadGenConfig`` (one ``random.Random``
seed), so the same config always yields the same schedule — benchmarks
compare allocator backends under *identical* admission pressure, and the
recorded multi-tenant engine trace is reproducible.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class SLOClass:
    """One service tier: latency deadlines + request-shape mix.

    Deadlines are in *modeled milliseconds* (the simulation's deterministic
    clock — see ``repro.serve.simulate``), so SLO attainment is a
    load-independent, gateable number.
    """

    name: str
    ttft_deadline_ms: float
    tpot_deadline_ms: float
    prompt_tokens: Tuple[int, int]  # inclusive range
    decode_tokens: Tuple[int, int]
    weight: float  # share of tenants in this class


#: The default tier mix. Names align with ``repro.serve.engine.SLO_PRIORITY``
#: (admission order: interactive < standard < batch).
SLO_CLASSES: Dict[str, SLOClass] = {
    c.name: c
    for c in (
        SLOClass("interactive", ttft_deadline_ms=500.0, tpot_deadline_ms=50.0,
                 prompt_tokens=(16, 256), decode_tokens=(8, 64), weight=0.5),
        SLOClass("standard", ttft_deadline_ms=1500.0, tpot_deadline_ms=100.0,
                 prompt_tokens=(64, 1024), decode_tokens=(32, 256),
                 weight=0.35),
        SLOClass("batch", ttft_deadline_ms=10_000.0, tpot_deadline_ms=500.0,
                 prompt_tokens=(512, 4096), decode_tokens=(128, 512),
                 weight=0.15),
    )
}


@dataclass(frozen=True)
class RequestSpec:
    """One arrival: who asks for what, when."""

    step: int  # arrival step (simulation ticks)
    user_id: int  # drawn from the n_users id space
    tenant: str
    slo: str  # SLOClass name
    prompt_tokens: int
    decode_tokens: int


@dataclass(frozen=True)
class LoadGenConfig:
    """Schedule shape. All randomness flows from ``seed``."""

    seed: int = 0
    n_users: int = 1_000_000
    n_tenants: int = 8
    duration_steps: int = 400
    #: mean arrivals per step at the diurnal midpoint
    base_arrivals_per_step: float = 3.0
    #: diurnal sinusoid: rate swings by ±amplitude around the base over
    #: one period (a compressed day)
    diurnal_period_steps: int = 200
    diurnal_amplitude: float = 0.6
    #: bursts: (start_step, extra_arrivals_per_step, length_steps)
    bursts: Tuple[Tuple[int, float, int], ...] = ((120, 6.0, 12), (260, 9.0, 8))

    def describe(self) -> dict:
        return {
            "seed": self.seed,
            "n_users": self.n_users,
            "n_tenants": self.n_tenants,
            "duration_steps": self.duration_steps,
            "base_arrivals_per_step": self.base_arrivals_per_step,
            "bursts": list(map(list, self.bursts)),
        }


def _poisson(rng: random.Random, lam: float) -> int:
    """Knuth's method — fine for the per-step rates this generator uses."""
    if lam <= 0.0:
        return 0
    limit = math.exp(-lam)
    n, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return n
        n += 1


@dataclass
class TenantDirectory:
    """Deterministic tenant -> SLO-class assignment (weight-proportional)."""

    n_tenants: int
    classes: Tuple[str, ...] = field(default_factory=tuple)

    def __post_init__(self):
        if not self.classes:
            # largest-remainder apportionment of tenants to classes keeps
            # the mix faithful at any tenant count
            specs = list(SLO_CLASSES.values())
            quotas = [c.weight * self.n_tenants for c in specs]
            counts = [int(q) for q in quotas]
            while sum(counts) < self.n_tenants:
                i = max(range(len(specs)), key=lambda j: quotas[j] - counts[j])
                counts[i] += 1
            names: List[str] = []
            for c, n in zip(specs, counts):
                names.extend([c.name] * n)
            self.classes = tuple(names[: self.n_tenants])

    def slo_of(self, tenant_idx: int) -> str:
        return self.classes[tenant_idx % len(self.classes)]


def generate(cfg: LoadGenConfig) -> List[RequestSpec]:
    """The full arrival schedule for ``cfg``, sorted by step.

    Per step: the diurnal base rate plus any active burst gives a Poisson
    mean; each arrival draws a user id from the million-user space, a
    tenant (which fixes the SLO class), and a prompt/decode shape from the
    class's mix.
    """
    rng = random.Random(cfg.seed)
    directory = TenantDirectory(cfg.n_tenants)
    out: List[RequestSpec] = []
    for step in range(cfg.duration_steps):
        rate = cfg.base_arrivals_per_step * (
            1.0
            + cfg.diurnal_amplitude
            * math.sin(2.0 * math.pi * step / cfg.diurnal_period_steps)
        )
        for start, extra, length in cfg.bursts:
            if start <= step < start + length:
                rate += extra
        for _ in range(_poisson(rng, rate)):
            t_idx = rng.randrange(cfg.n_tenants)
            slo = SLO_CLASSES[directory.slo_of(t_idx)]
            p_lo, p_hi = slo.prompt_tokens
            d_lo, d_hi = slo.decode_tokens
            out.append(
                RequestSpec(
                    step=step,
                    user_id=rng.randrange(cfg.n_users),
                    tenant=f"t{t_idx}",
                    slo=slo.name,
                    prompt_tokens=rng.randint(p_lo, p_hi),
                    decode_tokens=rng.randint(d_lo, d_hi),
                )
            )
    return out


__all__ = [
    "SLOClass",
    "SLO_CLASSES",
    "RequestSpec",
    "LoadGenConfig",
    "TenantDirectory",
    "generate",
]
