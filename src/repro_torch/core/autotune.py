"""Offline geometry tuning (paper §5.5, Table 3), over the port's spaces.

Two searchers over the per-pattern <L,S,C> spaces of
``repro_torch.core.geometry`` (the reference's ``core/autotune.py``, the same
algorithms):

  * ``brute_force``   -- evaluate every valid tuple (the paper's "B.F. Search");
  * ``pruned_search`` -- the paper's "R.L. Search": a per-coordinate hill walk
    on the powers-of-two grid that stops on an axis the first time the cost
    worsens (the performance structure is monotone or unimodal along each axis).

Both take a ``measure`` callable, so the same search runs against the analytic
model (``analytic_measure``) or against the card: ``chip_smoke.py`` times each
probed geometry with CUDA events and holds its output bitwise against the
plain version.  The package has no measuring function of its own.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.geometry import SPACES, ChipSpec, Geometry, analytic_cost_ns


@dataclasses.dataclass
class TuneResult:
    best: Geometry
    cost: float
    probes: int
    history: list[tuple[Geometry, float]]


def brute_force(pattern: str, spec: ChipSpec, measure: Callable[[Geometry], float],
                itemsize: int = 4) -> TuneResult:
    history = []
    best, best_cost = None, float("inf")
    for g in SPACES[pattern](spec, itemsize):
        c = measure(g)
        history.append((g, c))
        if c < best_cost:
            best, best_cost = g, c
    return TuneResult(best, best_cost, probes=len(history), history=history)


def _axis_values(pattern: str, spec: ChipSpec, itemsize: int) -> dict[str, list[int]]:
    space = list(SPACES[pattern](spec, itemsize))
    return {ax: sorted({getattr(g, ax) for g in space}) for ax in ("L", "S", "C")}


def pruned_search(pattern: str, spec: ChipSpec, measure: Callable[[Geometry], float],
                  itemsize: int = 4) -> TuneResult:
    """Coordinate descent with a monotone early exit per axis.

    For each axis in turn, walk the powers-of-two ladder up, then down, from the
    current value and stop the first time the cost does not improve
    (unimodality).  Measurements are cached, so no geometry is probed twice,
    and the passes repeat until one improves nothing (noisy measurements)."""
    axes = _axis_values(pattern, spec, itemsize)
    valid = set(SPACES[pattern](spec, itemsize))
    cache: dict[Geometry, float] = {}

    def probe(g: Geometry) -> float | None:
        if g not in valid:
            return None
        if g not in cache:
            cache[g] = measure(g)
        return cache[g]

    # start at the smallest valid tuple
    cur = Geometry(axes["L"][0], axes["S"][0], axes["C"][0])
    if cur not in valid:
        cur = next(iter(sorted(valid, key=lambda g: g.tile)))
    cur_cost = probe(cur)
    assert cur_cost is not None
    improved = True
    while improved:
        improved = False
        for ax in ("L", "S", "C"):
            ladder = axes[ax]
            start = ladder.index(getattr(cur, ax))
            for direction in (1, -1):
                k = start + direction
                while 0 <= k < len(ladder):
                    g = dataclasses.replace(cur, **{ax: ladder[k]})
                    c = probe(g)
                    if c is None or c >= cur_cost:
                        break
                    cur, cur_cost, improved = g, c, True
                    k += direction
    history = sorted(cache.items(), key=lambda kv: kv[1])
    return TuneResult(cur, cur_cost, probes=len(cache), history=history)


def analytic_measure(pattern: str, spec: ChipSpec, n_elems: int = 1 << 24,
                     itemsize: int = 4) -> Callable[[Geometry], float]:
    return lambda g: analytic_cost_ns(pattern, g, n_elems, itemsize, spec)
