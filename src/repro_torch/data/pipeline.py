"""Deterministic, shardable, resumable synthetic token pipeline.

Counterpart of ``repro.data.pipeline``: every batch is a pure function of
(seed, step, host) drawn from the same numpy ``SeedSequence`` stream, so
``batch_at(step)["tokens"]`` is bit-identical to the reference's, and a
restart replays the exact stream. Tokens come back as int32 on the device
the pipeline was made for. Length buckets cycle with the step. With
``patch_dim`` (the vlm family) a batch also carries 16 seeded float32
patch embeddings a sequence, and with ``frame_dim`` (the audio family) one
seeded float32 frame embedding a position, drawn after the patches from
the same stream, as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    #: length-bucket multipliers, one per step in turn
    buckets: Tuple[float, ...] = (1.0,)
    #: vlm: width of the patch embeddings
    patch_dim: Optional[int] = None
    #: audio: width of the frame embeddings
    frame_dim: Optional[int] = None


class SyntheticTokens:
    """Markov-ish synthetic LM stream a model can reduce its loss on:
    token_{t+1} = (token_t + drift + noise) % vocab, drift per sequence."""

    def __init__(self, cfg: DataConfig, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def seq_len_for(self, step: int) -> int:
        b = self.cfg.buckets[step % len(self.cfg.buckets)]
        return max(16, int(self.cfg.seq_len * b))

    def batch_at(self, step: int, host_id: int = 0, n_hosts: int = 1) -> Dict:
        """This host's slice of the global batch at ``step``."""
        cfg = self.cfg
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{n_hosts} hosts")
        local = cfg.global_batch // n_hosts
        s = self.seq_len_for(step)
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, host_id]))
        drift = rng.integers(1, 17, size=(local, 1))
        noise = rng.integers(0, 3, size=(local, s))
        t0 = rng.integers(0, cfg.vocab, size=(local, 1))
        steps = np.arange(s)[None, :]
        toks = (t0 + drift * steps + np.cumsum(noise, axis=1)) % cfg.vocab
        batch = {"tokens": torch.from_numpy(toks.astype(np.int32)).to(self.device)}
        if cfg.patch_dim is not None:
            patches = rng.standard_normal((local, 16, cfg.patch_dim)).astype(np.float32)
            batch["patch_embeds"] = torch.from_numpy(patches).to(self.device)
        if cfg.frame_dim is not None:
            frames = rng.standard_normal((local, s, cfg.frame_dim)).astype(np.float32)
            batch["frames"] = torch.from_numpy(frames).to(self.device)
        return batch

    def __iter__(self) -> Iterator[Dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
