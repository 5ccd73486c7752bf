"""The one generator of traffic: it reads a mix's data file and makes the
inputs from the run's seed.

Two kinds of mix exist:

* ``train``: batches of ``batch`` rows, ``distinct_batches`` of them drawn
  on the device and cycled; the model's family says what a row holds
  (``harness/families/<family>.py``: ``seq`` token ids, uniform over the
  vocabulary, and for the audio family ``frames`` frame embeddings).
* ``closed_loop``: a stream of requests, each a prompt of token ids and
  the number of tokens to generate. Lengths follow each distribution by
  stratified quantiles: every ``block`` requests (a power of two) hold the
  same lengths, the (i + 1/2)/block quantiles. Request i of a block takes
  the prompt length of rank vdc(i) and the output length of rank s2(i),
  the first two coordinates of the Sobol sequence in base 2 (van der
  Corput, and the one of polynomial x + 1), each XOR-ed with a mask drawn
  for the block from ``ORDER_SEED``: the pairs of prompt and output ranks
  spread over the square as a (0, m, 2)-net, so no block pairs long
  prompts with long answers, and every aligned run of 2**k requests holds
  one length from each of 2**k equal strata of either distribution. The
  masks change the pairing from block to block, where one fixed
  permutation would serve the same 64 pairs in every block. The order is
  the same for every run and every mix: the run's seed draws the token
  ids. Which requests fall in a window, and with them how many prompts of
  costly length (the program tiles a prime length above 512 one token at
  a time), would otherwise change with the seed: seeds moved a window's
  throughput by up to 37 % where two runs of one seed moved it under 4 %.
  A block small beside a window (64 against some 230 requests) keeps what
  a window holds close to the block's own shares.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from . import families
from .seeds import derive, rng

#: draws each block's masks: one constant, so the order of lengths is no
#: parameter of a mix or of a run
ORDER_SEED = 0


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """The (i + 1/2)/n quantiles of a length distribution, as whole numbers."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = dist["lo"], dist["hi"]
    if dist["dist"] == "log_uniform":
        x = lo * (hi / lo) ** u
    elif dist["dist"] == "uniform":
        x = lo + (hi - lo) * u
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.floor(x + 0.5), lo, hi).astype(np.int64)


def net_ranks(n: int, masks: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """For i < n (a power of two): the ranks (vdc(i) ^ masks[0],
    s2(i) ^ masks[1]) of the first two base-2 Sobol coordinates."""
    bits = n.bit_length() - 1
    if n != 1 << bits:
        raise ValueError(f"block must be a power of two, got {n}")
    first, second = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for i in range(n):
        v1, v2 = n >> 1, n >> 1
        for j in range(bits):
            if (i >> j) & 1:
                first[i] ^= v1
                second[i] ^= v2
            v1 >>= 1
            v2 ^= v2 >> 1
    return first ^ (masks[0] % n), second ^ (masks[1] % n)


def requests(mix: Dict, vocab: int, seed: int) -> Iterator[Tuple[np.ndarray, int]]:
    """(prompt, max_new) pairs without end, block by block."""
    n = mix["block"]
    prompts, outputs = quantiles(mix["prompt"], n), quantiles(mix["output"], n)
    for block in range(1 << 62):
        order = rng(ORDER_SEED, "order", block)
        p_rank, o_rank = net_ranks(n, (int(order.integers(n)), int(order.integers(n))))
        p_len, o_len = prompts[p_rank], outputs[o_rank]
        r = rng(seed, "requests", block)
        for i in range(n):
            yield r.integers(0, vocab, size=int(p_len[i]), dtype=np.int32), int(o_len[i])


def train_batches(mix: Dict, family: str, model: Dict, seed: int, device) -> List[Dict]:
    """``distinct_batches`` batches drawn on ``device``, each from a
    generator of its own, as the family draws a batch."""
    draw = families.of(family).train_batch
    out = []
    for i in range(mix["distinct_batches"]):
        g = torch.Generator(device=device)
        g.manual_seed(derive(seed, "batch", i))
        out.append(draw(mix, model, g, device))
    return out
