"""Requests of a traffic mix, from a fixed quantile sequence.

A mix is a JSON file ``traffic/<mix>.json`` (the laws of the lengths and
the closed loop's sizes); ``traffic/<mix>/<config>.json``, where it exists,
is merged over it for that configuration (its slot count, ``max_len`` or a
law of its own).

Request i gets prompt quantile u_i = frac(u0 + i * prompt_step) and output
quantile v_i = frac(v0 + i * output_step), each mapped through the mix's
law and clipped to its range.  Any n consecutive requests cover each law
with a discrepancy of order (log n) / n.  u0 and v0 are the mix's own
(``start``), so every seed serves the same lengths in the same order: a
tail percentile of a closed loop depends on which requests end in the
same step, which the order of the lengths decides.  The seed draws the
token ids (uniform over the vocabulary) and the weights.
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
_NORMAL = statistics.NormalDist()
_EDGE = 1e-9
WARM_LENGTHS = 8
BIASED_GRID = 4096


def load_mix(mix: str, config: str) -> dict:
    """The mix's parameters, with the configuration's overlay merged over them."""
    spec = json.loads((ROOT / "traffic" / f"{mix}.json").read_text())
    overlay = ROOT / "traffic" / mix / f"{config}.json"
    if overlay.exists():
        spec.update(json.loads(overlay.read_text()))
    for key in ("prompt", "output", "prompt_step", "output_step", "start", "slots", "max_len"):
        if key not in spec:
            raise ValueError(f"traffic {mix!r} for {config!r} has no {key!r}")
    return spec


def quantile(law: dict, u: float) -> int:
    """The length at quantile u of ``law``, clipped to [min, max]."""
    u = min(max(u, _EDGE), 1.0 - _EDGE)
    lo, hi = law["min"], law["max"]
    kind = law["law"]
    if kind == "lognormal":
        value = law["median"] * math.exp(law["sigma"] * _NORMAL.inv_cdf(u))
    elif kind == "loguniform":
        value = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif kind == "uniform":
        value = lo + math.floor(u * (hi - lo + 1))
    else:
        raise ValueError(f"unknown law {kind!r}")
    return int(min(max(round(value), lo), hi))


def biased_table(law: dict) -> tuple:
    """The law's lengths at ``BIASED_GRID`` even quantiles and the cumulative share
    of their sum: the law weighted by length (the law of the request a busy
    slot holds at a random time)."""
    lengths = np.array([quantile(law, (i + 0.5) / BIASED_GRID) for i in range(BIASED_GRID)],
                       np.float64)
    return lengths, np.cumsum(lengths) / lengths.sum()


class Traffic:
    """Request i of a run: (prompt token ids, output length)."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec = spec
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.u0, self.v0 = spec["start"]
        self._biased = None

    def lengths(self, i: int) -> tuple:
        """(prompt length, output length) of request i."""
        u = (self.u0 + i * self.spec["prompt_step"]) % 1.0
        v = (self.v0 + i * self.spec["output_step"]) % 1.0
        return quantile(self.spec["prompt"], u), quantile(self.spec["output"], v)

    def request(self, i: int) -> tuple:
        """(prompt token ids (int32), output length) of request i."""
        plen, out = self.lengths(i)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 1, i]))
        return rng.integers(0, self.vocab, plen, dtype=np.int32), out

    def in_flight(self, j: int, slots: int) -> tuple:
        """(prompt token ids, tokens still to come) of the request slot j
        holds when the window opens, as in a steady state: request j's
        prompt, an output length L drawn from the length-biased law (a slot
        is more often busy with a long request), and 1 + ceil((L - 1)(j +
        1) / slots) tokens still to come, so that the slots' remaining
        decode steps are spread evenly over a request's life."""
        if self._biased is None:
            self._biased = biased_table(self.spec["output"])
        lengths, cdf = self._biased
        tokens, _ = self.request(j)
        v = (self.v0 + j * self.spec["output_step"]) % 1.0
        length = int(lengths[min(int(np.searchsorted(cdf, v)), len(lengths) - 1)])
        return tokens, 1 + math.ceil((length - 1) * (j + 1) / slots)

    def warm_lengths(self) -> list:
        """Prompt lengths at WARM_LENGTHS even quantiles of the law, its ends included:
        set-up prefills each once, so the window meets no kernel for the
        first time."""
        n = WARM_LENGTHS
        return sorted({quantile(self.spec["prompt"], i / (n - 1)) for i in range(n)})
