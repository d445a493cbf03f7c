"""The generator of requests that the traffic kinds share: every mix is a
data file (``gpbench/traffic/<mix>.json``) whose kind
(``gpbench/traffic/kinds/<kind>.py``) runs it.

A mix of requests (``"sizes": [...] | "loguniform": {...}, "low",
"high"``) asks for batches of test points drawn uniformly from [low,
high]. The request sizes are a fixed multiset (listed, or ``count``
sizes at the midpoints of ``count`` equal steps of log-size between
``low`` and ``high``, rounded), walked again and again in an order drawn from the seed that spreads every
stretch of it evenly over the sizes (:func:`balanced_order`): every seed
asks for the same work in another order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gpbench.lib.system import generator, seed_for


def request_sizes(mix: dict) -> list:
    if "sizes" in mix:
        return list(mix["sizes"])
    lu = mix["loguniform"]
    lo, hi, k = math.log(lu["low"]), math.log(lu["high"]), lu["count"]
    return [int(round(math.exp(lo + (i + 0.5) * (hi - lo) / k)))
            for i in range(k)]


def balanced_order(sizes: list, rng) -> list:
    """The sizes in an order drawn from ``rng`` in which every stretch from
    the start is spread evenly over the multiset: ranked by size, taken in
    bit-reversed rank order (a van der Corput sequence) with the rank bits
    scrambled by a mask drawn from ``rng``. So any window that ends part of
    the way through a walk asks for nearly the same mix of sizes whatever
    the seed. The multiset's length is a power of two."""
    ranked = sorted(sizes)
    n = len(ranked)
    bits = n.bit_length() - 1
    if n & (n - 1):
        raise ValueError(f"{n} request sizes: a mix lists a power of two")
    mask = int(rng.integers(n))
    rev = [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
           for i in range(n)]
    return [ranked[r ^ mask] for r in rev]


class Requests:
    """The requests of one run, in order: ``next()`` gives the test points
    [size, d] on ``device``."""

    def __init__(self, mix: dict, seed: int, device, d: int, tag="window"):
        rng = np.random.default_rng(seed_for(seed, "order-" + tag))
        self.order = balanced_order(request_sizes(mix), rng)
        self.g = generator(seed_for(seed, "points-" + tag), device)
        self.lo, self.hi = mix["low"], mix["high"]
        self.device, self.d, self.i = device, d, 0

    def next(self) -> torch.Tensor:
        size = self.order[self.i % len(self.order)]
        self.i += 1
        u = torch.rand(size, self.d, generator=self.g, device=self.device)
        return self.lo + (self.hi - self.lo) * u
