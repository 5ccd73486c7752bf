"""repro.chaos — chaos campaigns over the allocator subsystem.

Composes deterministic fault scenarios (``scenarios``) from the
preemption-trace format in ``repro.alloc.chunks``, drives them against
every registered backend (``campaign``) through replay, the serving
simulator and the kill/recover engine scenario, and watches the run with
an online invariant sentinel (``sentinel``) that attributes the first
safety violation to the event that triggered it.

Quickstart::

    from repro.chaos import CampaignConfig, run_campaign
    result = run_campaign(CampaignConfig(fast=True))
    assert result.ok, result.failures()

``benchmarks/bench_chaos.py`` publishes ``result.to_payload()`` as
``BENCH_chaos.json`` and the CI gate (``compare_replay.py``) blocks on
verdict regressions.
"""

from .campaign import (
    ENGINE_BACKENDS,
    CampaignConfig,
    CampaignResult,
    LegVerdict,
    run_campaign,
    run_engine_leg,
    run_replay_leg,
    run_serving_leg,
)
from .scenarios import (
    DEFAULT_TRACE_PATH,
    ChaosScenario,
    brownout,
    capacity_storm,
    from_trace_file,
    spot_revocation,
    standard_campaign,
    sustained_pressure,
    transient_flurry,
)
from .sentinel import InvariantSentinel, Violation

__all__ = [
    "ENGINE_BACKENDS",
    "CampaignConfig",
    "CampaignResult",
    "LegVerdict",
    "run_campaign",
    "run_engine_leg",
    "run_replay_leg",
    "run_serving_leg",
    "DEFAULT_TRACE_PATH",
    "ChaosScenario",
    "brownout",
    "capacity_storm",
    "from_trace_file",
    "spot_revocation",
    "standard_campaign",
    "sustained_pressure",
    "transient_flurry",
    "InvariantSentinel",
    "Violation",
]
