"""Continuous-batching serving engine over the stitched KV arena.

Counterpart of ``repro.serve.engine``. Each request's KV history is a
stitched allocation; admission/retirement churn is exactly the irregular
alloc/free stream that fragments a splitting allocator, and the engine
emits the real trace through ``TraceRecorder`` so it can be replayed
against caching vs GMLake.

As in the reference, the model runs on a dense per-slot KV cache, and every
admission, growth and retirement drives the GMLake-backed
``StitchedKVCache`` for allocation accounting, token for token. The
stitched data path (``StitchedKVCache.write_tokens`` / ``decode_attention``,
which reach the CUDA kernels) is held against the plain dense path by
``chip_smoke.py``. On the card the dense cache is read by the same decode
attention kernel, one chunk a slot (``models/layers.py``).

Its steps, admissions, prefills, decodes and samplings are spans
(``serve.*``) with counters of the work, while tracing is on
(``utils/tracing.py``; ``docs/TRACING_TORCH.md``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.kvcache import KVCacheConfig, StitchedKVCache
from ..core.trace import TraceRecorder
from ..device import DeviceLike, resolve_device
from ..models.api import family_of
from ..utils.tracing import count, span, spanned

#: Admission priority per SLO class (lower admits first). Requests with an
#: empty or unknown class share the default rank, so single-tenant
#: workloads keep exact FIFO order — the sort below is stable.
SLO_PRIORITY = {"interactive": 0, "standard": 1, "batch": 2}
_DEFAULT_PRIORITY = 1


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    generated: List[int] = field(default_factory=list)
    done: bool = False
    # multi-tenant metadata + per-life latency accounting (engine steps).
    # Not part of dump_state: a restore starts a fresh latency life, the
    # same contract as the memory-report event counters.
    tenant: str = ""
    slo: str = ""
    submit_step: int = 0
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None


@dataclass
class EngineConfig:
    max_batch: int = 8
    max_len: int = 1024
    n_chunks: int = 512
    #: where the model, its dense cache and the KV arena live
    device: DeviceLike = "cuda"
    #: KV-arena backend: any ``repro_torch.alloc`` registry key (or instance)
    allocator: object = "gmlake"
    #: optional KV *accounting* geometry overrides (n_kv heads / head dim).
    #: The model still executes on its own shapes; these let a scenario
    #: model the per-token KV footprint of a larger deployment.
    kv_n_kv: Optional[int] = None
    kv_head_dim: Optional[int] = None


def _host(leaf) -> np.ndarray:
    """A ``dump_state`` leaf as a host array: restores hand back tensors,
    on the card when the supervisor restores onto it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.cpu().numpy()
    return np.asarray(leaf)


class ServeEngine:
    """Dense-cache model execution + stitched-arena KV accounting."""

    def __init__(self, cfg, params, engine_cfg: EngineConfig = EngineConfig()):
        self.cfg = cfg
        self.params = params
        self.ecfg = engine_cfg
        self.device = resolve_device(engine_cfg.device)
        self.fam = family_of(cfg)
        self.recorder = TraceRecorder(kind="serve", model=cfg.name)
        self.kv = StitchedKVCache(
            KVCacheConfig(
                n_layers=getattr(cfg, "n_layers", 1),
                n_kv=engine_cfg.kv_n_kv or getattr(cfg, "n_kv", 1),
                head_dim=engine_cfg.kv_head_dim or getattr(cfg, "dh", 64),
                dtype=torch.bfloat16,
                n_chunks=engine_cfg.n_chunks,
                device=self.device,
            ),
            recorder=self.recorder,
            allocator=engine_cfg.allocator,
        )
        self._next_id = itertools.count()
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}
        self.finished: List[Request] = []  # completion order
        self._requests: Dict[int, Request] = {}  # every submitted request
        self._cache = None  # dense model cache for the running batch
        self._slot_of: Dict[int, int] = {}
        self.steps = 0  # decode steps driven so far (dump/load identity)
        # set while a step is mutating engine state; a crash mid-step
        # leaves it set, forcing the next load_state to rebuild rather
        # than trust the partially-mutated in-memory state
        self._dirty = False

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 32,
               tenant: str = "", slo: str = "") -> int:
        rid = next(self._next_id)
        req = Request(rid, np.asarray(prompt, np.int32), max_new,
                      tenant=tenant, slo=slo, submit_step=self.steps)
        self.waiting.append(req)
        self._requests[rid] = req
        return rid

    # ------------------------------------------------------------------
    @spanned("serve.admit")
    def _admit(self) -> None:
        # SLO-class admission: interactive ahead of standard ahead of
        # batch; the sort is stable, so same-class requests (and every
        # request of an SLO-free workload) stay strictly FIFO
        if len(self.waiting) > 1 and any(r.slo for r in self.waiting):
            self.waiting.sort(
                key=lambda r: SLO_PRIORITY.get(r.slo, _DEFAULT_PRIORITY)
            )
        while self.waiting and len(self.running) < self.ecfg.max_batch:
            req = self.waiting.pop(0)
            self.running[req.req_id] = req
            self.recorder.set_context(req.tenant, req.slo)
            self.kv.add_sequence(req.req_id, len(req.prompt))
            self.recorder.set_context()
            slot = self._alloc_slot(req)
            # dense prefill for this request alone (simple; batched prefill
            # is an optimization the engine does not need for correctness)
            cache = self.fam.init_cache(self.cfg, 1, self.ecfg.max_len, self.device)
            tokens = torch.as_tensor(req.prompt[None, :], device=self.device)
            count("serve.admitted")
            count("serve.prefill_tokens", len(req.prompt))
            with span("serve.prefill", req.req_id):
                logits, cache = self.fam.prefill(self.cfg, self.params, {"tokens": tokens}, cache)
                req.generated.append(int(torch.argmax(logits[0, -1])))
            if req.first_token_step is None:
                req.first_token_step = self.steps
            self._merge_cache(slot, cache)

    def _alloc_slot(self, req: Request) -> int:
        slot = len(self._slot_of)
        for s in range(self.ecfg.max_batch):
            if s not in self._slot_of.values():
                slot = s
                break
        self._slot_of[req.req_id] = slot
        return slot

    def _ensure_cache(self) -> None:
        if self._cache is None:
            self._cache = self.fam.init_cache(self.cfg, self.ecfg.max_batch,
                                              self.ecfg.max_len, self.device)

    def _merge_cache(self, slot: int, cache_1: Dict) -> None:
        self._ensure_cache()
        for name, one in cache_1.items():
            if one.dim() >= 2:  # (L, 1, ...) layer-stacked
                self._cache[name][:, slot : slot + 1] = one
            else:
                self._cache[name][slot : slot + 1] = one

    # ------------------------------------------------------------------
    @spanned("serve.step")
    def step(self) -> int:
        """One decode step over the running batch. Returns #finished."""
        self._dirty = True
        self._admit()
        if not self.running:
            self.steps += 1
            self._dirty = False
            return 0
        reqs = list(self.running.values())
        slots = [self._slot_of[r.req_id] for r in reqs]
        tokens = np.zeros((self.ecfg.max_batch,), np.int32)
        for r, s in zip(reqs, slots):
            tokens[s] = r.generated[-1]
        with span("serve.decode"):  # keeps the decode call out of serve.step's self time
            logits, self._cache = self.fam.decode_step(
                self.cfg, self.params, self._cache, torch.as_tensor(tokens, device=self.device)
            )
        count("serve.decoded_rows", len(reqs))
        with span("serve.sample"):  # where an untraced host waits for the decode
            next_tokens = torch.argmax(logits, dim=-1).tolist()
        finished = 0
        for r, s in zip(reqs, slots):
            r.generated.append(next_tokens[s])
            self.recorder.set_context(r.tenant, r.slo)
            self.kv.append_tokens(r.req_id, 1)
            self.recorder.set_context()
            if len(r.generated) >= r.max_new:
                r.done = True
                r.finish_step = self.steps
                finished += 1
                self.finished.append(r)
                self.kv.free_sequence(r.req_id)
                del self.running[r.req_id]
                del self._slot_of[r.req_id]
        self.steps += 1
        self._dirty = False
        return finished

    def run_to_completion(self, max_steps: int = 10_000) -> List[Request]:
        """Drive ``step`` until every submitted request finishes (or the
        step budget runs out); returns the requests that finished during
        this call, in completion order."""
        start = len(self.finished)
        for _ in range(max_steps):
            if not self.waiting and not self.running:
                break
            self.step()
        return self.finished[start:]

    # ------------------------------------------------------------------
    # checkpointable state (kill/recover path)
    # ------------------------------------------------------------------
    def dump_state(self) -> Dict[str, Any]:
        """Engine state as a fixed-structure tree of arrays and tensors.

        The layout (array shapes) is a function of the *submitted request
        set*, so dumps are restore-compatible as long as no new requests
        arrive between save and restore — exactly the kill/recover serving
        contract. Phase encoding: 0 waiting, 1 running, 2 finished.
        """
        self._ensure_cache()
        reqs = [self._requests[rid] for rid in sorted(self._requests)]
        n = len(reqs)
        p_max = max((len(r.prompt) for r in reqs), default=1)
        g_max = max((r.max_new for r in reqs), default=1)
        prompt_tok = np.zeros((n, p_max), np.int32)
        prompt_len = np.zeros((n,), np.int32)
        gen_tok = np.zeros((n, g_max), np.int32)
        gen_len = np.zeros((n,), np.int32)
        max_new = np.zeros((n,), np.int32)
        phase = np.zeros((n,), np.int32)
        slot = np.full((n,), -1, np.int32)
        for i, r in enumerate(reqs):
            pl = len(r.prompt)
            prompt_tok[i, :pl] = r.prompt
            prompt_len[i] = pl
            gl = len(r.generated)
            gen_tok[i, :gl] = np.asarray(r.generated, np.int32)
            gen_len[i] = gl
            max_new[i] = r.max_new
            if r.done:
                phase[i] = 2
            elif r.req_id in self.running:
                phase[i] = 1
                slot[i] = self._slot_of[r.req_id]
        return {
            "step": np.int32(self.steps),
            "prompt_tok": prompt_tok,
            "prompt_len": prompt_len,
            "gen_tok": gen_tok,
            "gen_len": gen_len,
            "max_new": max_new,
            "phase": phase,
            "slot": slot,
            "cache": {k: v.clone() for k, v in self._cache.items()},
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        """Restore engine + KV-arena accounting from a ``dump_state`` tree.

        No-op when ``state`` describes the step the engine is already at
        (and no step died half-way); otherwise a full rebuild: every live
        KV sequence is freed and re-admitted tight against the (possibly
        shrunken) device — the re-stitching defragmentation pass.
        """
        step = int(state["step"])
        if step == self.steps and not self._dirty:
            return
        # a real restore starts a new reporting life: recovery/event-log
        # counters accumulated before the crash must not leak into
        # post-restore memory reports (device-side fault counters are
        # device-lifetime and deliberately survive). The clear happens
        # before the rebuild below, so recoveries the rebuild itself walks
        # are counted as post-restore events.
        log = getattr(self.kv.arena.allocator, "event_log", None)
        if log is not None:
            log.clear()
        for sid in list(self.kv.seqs):
            self.kv.free_sequence(sid)
        self.waiting.clear()
        self.running.clear()
        self.finished.clear()
        self._slot_of.clear()
        prompt_tok = _host(state["prompt_tok"])
        prompt_len = _host(state["prompt_len"])
        gen_tok = _host(state["gen_tok"])
        gen_len = _host(state["gen_len"])
        max_new = _host(state["max_new"])
        phase = _host(state["phase"])
        slot = _host(state["slot"])
        running_rows = []
        for i in range(prompt_tok.shape[0]):
            rid = i  # req ids are dense: itertools.count() from 0
            pl = int(prompt_len[i])
            req = Request(rid, prompt_tok[i, :pl].astype(np.int32),
                          int(max_new[i]))
            req.generated = [int(t) for t in gen_tok[i, : int(gen_len[i])]]
            self._requests[rid] = req
            ph = int(phase[i])
            if ph == 0:
                self.waiting.append(req)
            elif ph == 1:
                self.running[rid] = req
                self._slot_of[rid] = int(slot[i])
                running_rows.append((rid, pl, len(req.generated)))
            else:
                req.done = True
                self.finished.append(req)
        # rebuild KV accounting exactly as admission would have: one
        # add_sequence(prompt_len) then one append per decoded token
        for rid, pl, gl in running_rows:
            self.kv.add_sequence(rid, pl)
            if gl > 1:
                self.kv.append_tokens(rid, gl - 1)
        self._cache = {k: torch.as_tensor(v, device=self.device).clone()
                       for k, v in state["cache"].items()}
        self.steps = step
        self._dirty = False
        self.recorder.mark(f"engine.restore@{step}")

    def run_supervised(self, ckpt, max_steps: int = 512,
                       config=None) -> "Supervisor":
        """Drive the engine to completion under a ``Supervisor``.

        Each supervisor step is one engine decode step over the dumped
        state; an ``AllocatorOOM`` (or any recoverable error) triggers
        restore from the last committed checkpoint onto the engine's
        device, and ``load_state`` rebuilds the KV arena tight on whatever
        capacity the device still has. Returns the supervisor (its
        ``events`` log is the audit trail the kill/recover scenario
        asserts on).
        """
        from ..ft.supervisor import Supervisor, SupervisorConfig

        cfg = config if config is not None else SupervisorConfig(
            checkpoint_every=4, max_restarts=8, restart_reset_after=8,
        )

        def step_fn(state, batch):
            self.load_state(state)
            self.step()
            return self.dump_state(), {
                "finished": float(len(self.finished)),
                "running": float(len(self.running)),
            }

        sup = Supervisor(step_fn, lambda i: None, ckpt, cfg, device=self.device)
        state = self.dump_state()
        ckpt.save(0, state)  # a restore target exists before any step
        done = 0
        while (self.waiting or self.running) and done < max_steps:
            chunk = min(cfg.checkpoint_every, max_steps - done)
            state, _ = sup.run(state, done, chunk)
            done += chunk
            self.load_state(state)
        return sup

    # ------------------------------------------------------------------
    def latency_report(self) -> Dict[str, Any]:
        """Per-SLO-class TTFT/TPOT in engine decode steps.

        TTFT counts submit -> first token inclusive (a request admitted
        and prefilled in the step after submission scores 1); TPOT is the
        mean decode interval over a finished request's generated tokens.
        Requests with no SLO class report under ``"default"``. Latency
        metadata lives per engine life (restores reset it), mirroring the
        memory-report event counters.
        """
        per: Dict[str, Dict[str, List[float]]] = {}
        for rid in sorted(self._requests):
            r = self._requests[rid]
            if r.first_token_step is None:
                continue
            d = per.setdefault(r.slo or "default", {"ttft": [], "tpot": []})
            d["ttft"].append(float(r.first_token_step - r.submit_step + 1))
            if r.finish_step is not None and len(r.generated) > 1:
                d["tpot"].append(
                    (r.finish_step - r.first_token_step)
                    / (len(r.generated) - 1)
                )
        report: Dict[str, Any] = {}
        for cls, d in sorted(per.items()):
            ttft, tpot = d["ttft"], d["tpot"]
            report[cls] = {
                "n": len(ttft),
                "ttft_steps_mean": sum(ttft) / len(ttft),
                "ttft_steps_max": max(ttft),
                "tpot_steps_mean": (sum(tpot) / len(tpot)) if tpot else None,
                "tpot_steps_max": max(tpot) if tpot else None,
            }
        return report

    # ------------------------------------------------------------------
    def memory_report(self) -> Dict[str, Any]:
        """Allocator-side report. ``recovery_events`` covers the current
        engine life (restores clear it); ``injected_faults`` is
        device-lifetime."""
        alloc = self.kv.arena.allocator
        counts = getattr(alloc, "state_counts", None)  # gmlake-style backends
        event_log = getattr(alloc, "event_log", None)
        vec_counters = getattr(alloc, "vec_counters", None)
        hybrid_counters = getattr(alloc, "hybrid_counters", None)
        device = self.kv.arena.device_model
        fault_counts = getattr(device, "fault_counts", None)
        return {
            "allocator": alloc.name,
            "reserved_bytes": alloc.reserved_bytes,
            "active_bytes": alloc.stats.active_bytes,
            "peak_reserved": alloc.stats.peak_reserved,
            "peak_active": alloc.stats.peak_active,
            "utilization": alloc.stats.utilization,
            "state_counts": dict(counts) if counts is not None else None,
            "n_trace_events": len(self.recorder.trace),
            "recovery_events": (event_log.summary()
                                if event_log is not None and len(event_log)
                                else None),
            "injected_faults": (dict(fault_counts)
                                if fault_counts else None),
            "pending_unmaps": getattr(alloc, "pending_unmaps", 0),
            "vec_counters": (dict(vec_counters)
                             if vec_counters is not None else None),
            "hybrid_counters": (dict(hybrid_counters)
                                if hybrid_counters is not None else None),
        }
