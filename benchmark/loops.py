"""What a traffic generator hands the harness, and the window's sample.

A mix (``benchmark/traffic/<mix>.json``) names its generator,
``benchmark/generators/<name>.py``, which holds

  ``make_inputs(cell, words, seed) -> Inputs``: the set-up's requests and
      the window's queries, from the seed;
  ``caller(cell, engine) -> fn(request) -> one (keys, scores) per query``;
  ``run_window(cell, call, engine, pool, sample, seconds, max_requests)
      -> Window``: the measured window (``seconds``), or ``max_requests``
      requests of a traced run; every answer is offered to ``sample``.

A generator draws its queries from a query model that the mix names,
``benchmark/queries/<name>.py`` (``draw(words, n, rng) -> queries``).
"""

from __future__ import annotations

import dataclasses
import math
import random


@dataclasses.dataclass
class Inputs:
    warmup: list  # the set-up's requests, each a list of queries
    pool: list  # the window's queries, in the order they are sent


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length
    (Li's Algorithm L), its draws from ``rng``: a few per replaced item."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0
        self._w = math.exp(math.log(self._u()) / k) if k else 0.0
        self._next = k + self._skip() if k else None

    def _u(self) -> float:
        return self.rng.random() or 1e-300

    def _skip(self) -> int:
        return int(math.floor(math.log(self._u()) / math.log1p(-self._w)))

    def offer(self, items: list) -> None:
        start = self.seen
        self.seen += len(items)
        fill = min(len(items), max(self.k - start, 0))
        self.items.extend(items[:fill])
        while self._next is not None and self._next < self.seen:
            self.items[self.rng.randrange(self.k)] = items[self._next - start]
            self._w *= math.exp(math.log(self._u()) / self.k)
            self._next += 1 + self._skip()


@dataclasses.dataclass
class Window:
    latencies: list  # seconds a request, submit to results on the host
    attempted: int  # queries sent
    failed: int  # queries with no answer (the call raised, or left it out)
    elapsed: float  # the window's seconds: its start to the last result
    sample: list  # [(query, (keys, scores))] to compare
    requests: list  # per request: (queries, the engine's routing after it)
    wrapped: bool  # the window ran past the pool
