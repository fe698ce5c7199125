"""Intra-call sharding: row-range split of ONE oversized ``run``.

``session.map`` already fans *independent* requests over healthy
destinations; this module is the other half of the ROADMAP's scale-out
story — alpa-style intra-op parallelism, where the leading batch axis of
a single large call's leaves is split into contiguous row ranges and the
sub-calls execute on different destinations concurrently.  The facade
(``repro_torch.avec.ClientSession.call(shard=True)``) stitches the sub-results
back into one response in range order, so the caller sees exactly the
tree an unsharded call would have returned.

Planning is deliberately conservative — a wrong split silently hands the
application wrong math, so the planner only splits when it can prove the
split is reversible:

* every input leaf must carry the batch on axis 0 with the SAME leading
  length (mirrors the coalescer's stacking precondition in
  ``repro_torch.core.executor._run_batch``, which is the same row-alignment
  contract run in reverse);
* each shard must get at least ``shard_min_rows`` rows — transport +
  dispatch overhead per sub-call is fixed, so degenerate slivers cost
  more than they parallelize ("Hardware-Accelerated Communication in
  Model-Serving Applications" is the cautionary tale: the wire, not
  compute, dominates small requests);
* at most ``shard_max_shards`` destinations participate (0 disables
  splitting entirely).

Both knobs resolve through ``repro_torch.obs.config`` (env
``AVEC_SHARD_MIN_ROWS`` / ``AVEC_SHARD_MAX_SHARDS``).  Shard sizes are
weighted by the scheduler's health/backpressure scores — a destination
predicted 2x slower gets ~half the rows — with every shard still clamped
to the minimum.

Stitching validates that every output leaf is row-aligned with its
shard's input rows before concatenating; a function that emits aggregate
leaves (a scalar loss, a pooled embedding) raises :class:`ShardStitchError`
instead of silently concatenating nonsense.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs.config import global_config
from repro_torch.utils import concat_rows, tree_leaves, tree_map

__all__ = ["RowRange", "ShardPlan", "ShardPlanner", "ShardStitchError",
           "leading_rows"]


class ShardStitchError(ValueError):
    """A sharded call's sub-results cannot be reassembled into the
    unsharded response (an output leaf is not row-aligned with its
    shard's input rows).  The offloaded function emits aggregate leaves
    and must run unsharded."""


@dataclass(frozen=True)
class RowRange:
    """One shard's contiguous slice ``[start, stop)`` of the batch axis."""
    index: int
    start: int
    stop: int

    @property
    def rows(self) -> int:
        return self.stop - self.start


def leading_rows(tree: Any) -> Optional[int]:
    """The shared leading-axis length of every leaf in ``tree``, or
    ``None`` when the tree is unsplittable: empty, any leaf is rank-0,
    or the leaves disagree on axis-0 length (per-request-constant leaves
    like masks would slice into nonsense)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return None
    rows: Optional[int] = None
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        if shape is None:
            shape = np.asarray(leaf).shape
        if len(shape) == 0:
            return None
        if rows is None:
            rows = int(shape[0])
        elif int(shape[0]) != rows:
            return None
    return rows


def _rows(leaf, start: int, stop: int):
    """Rows ``[start, stop)`` of one leaf as a view: a tensor or a host
    array (a ``BF16Array`` stays one) is sliced as it is."""
    if isinstance(leaf, (np.ndarray, torch.Tensor)):
        return leaf[start:stop]
    return np.asarray(leaf)[start:stop]


class ShardPlan:
    """An ordered row-range partition of one call's batch axis.

    ``split`` produces one sub-tree per range (zero-copy views — basic
    slicing of host arrays or tensors — so planning adds no serialize-side
    copies); ``stitch``
    is its exact inverse, concatenating per-shard output trees back in
    range order."""

    def __init__(self, rows: int, ranges: Sequence[RowRange]) -> None:
        self.rows = int(rows)
        self.ranges = tuple(ranges)

    @property
    def n_shards(self) -> int:
        return len(self.ranges)

    def split(self, tree: Any) -> list:
        """One input sub-tree per shard range, in range order."""
        return [tree_map(lambda leaf, r=r: _rows(leaf, r.start, r.stop), tree)
                for r in self.ranges]

    def stitch(self, parts: Sequence[Any]) -> Any:
        """Reassemble per-shard output trees into the unsharded response.

        Every output leaf must carry its shard's row count on axis 0 —
        the mirror of the input precondition — otherwise the function
        computed an aggregate and the split was semantically wrong:
        raise :class:`ShardStitchError` rather than hand back a
        concatenation of per-shard aggregates."""
        if len(parts) != self.n_shards:
            raise ShardStitchError(
                f"expected {self.n_shards} shard results, got {len(parts)}")
        for r, part in zip(self.ranges, parts):
            got = leading_rows(part)
            if got != r.rows:
                raise ShardStitchError(
                    f"shard {r.index} (rows {r.start}:{r.stop}) returned "
                    f"leaves with leading axis {got}, expected {r.rows}: "
                    f"the function emits aggregate (non-row-aligned) "
                    f"leaves and must run unsharded")
        if self.n_shards == 1:
            return parts[0]
        return tree_map(concat_rows, *parts)

    def describe(self) -> list[dict]:
        return [{"shard": r.index, "start": r.start, "stop": r.stop}
                for r in self.ranges]


class ShardPlanner:
    """Chooses how many row ranges one call splits into, and how big.

    ``weights`` (optional, one per candidate destination, ranked best
    first) skew shard sizes toward healthier destinations: the facade
    passes the inverse of the scheduler's predicted-latency scores, so
    a backpressured or saturated destination receives proportionally
    fewer rows instead of pacing the whole call."""

    def __init__(self, min_rows: Optional[int] = None,
                 max_shards: Optional[int] = None) -> None:
        cfg = global_config()
        self.min_rows = max(int(cfg.resolve("shard_min_rows", min_rows)), 1)
        self.max_shards = int(cfg.resolve("shard_max_shards", max_shards))

    def should_split(self, rows: Optional[int]) -> bool:
        """A call is worth splitting only when 2+ shards each clear the
        row floor — below ``2 * min_rows`` the "split" would be either a
        single shard or degenerate slivers, so it passes through."""
        return (rows is not None and self.max_shards > 1
                and rows >= 2 * self.min_rows)

    def plan(self, rows: int,
             weights: Optional[Sequence[float]] = None) -> ShardPlan:
        """Partition ``rows`` into at most ``max_shards`` contiguous
        ranges of at least ``min_rows`` each.  Returns a 1-shard
        (passthrough) plan whenever splitting is not worthwhile."""
        rows = int(rows)
        if not self.should_split(rows):
            return ShardPlan(rows, [RowRange(0, 0, rows)])
        n = min(self.max_shards, rows // self.min_rows)
        if weights is not None:
            n = min(n, len(weights))
        while n > 1:
            sizes = self._sizes(rows, n, weights)
            if sizes is not None:
                ranges, start = [], 0
                for idx, size in enumerate(sizes):
                    ranges.append(RowRange(idx, start, start + size))
                    start += size
                return ShardPlan(rows, ranges)
            n -= 1      # skewed weights broke the row floor: fewer shards
        return ShardPlan(rows, [RowRange(0, 0, rows)])

    def _sizes(self, rows: int, n: int,
               weights: Optional[Sequence[float]]) -> Optional[list[int]]:
        """Per-shard row counts for an ``n``-way split, or ``None`` when
        the weight skew cannot satisfy the per-shard floor at this ``n``."""
        w = [max(float(x), 1e-9) for x in (weights or [])][:n] or [1.0] * n
        total_w = sum(w)
        # proportional allocation with a per-shard floor: hand out floored
        # proportional sizes, then push the remainder onto the heaviest
        # shards (deterministic — no RNG, so plans are replayable)
        sizes = [max(int(rows * wi / total_w), self.min_rows) for wi in w]
        overshoot = sum(sizes) - rows
        while overshoot > 0:        # floors overshot: shed from the largest
            sizes[sizes.index(max(sizes))] -= 1
            overshoot -= 1
        order = sorted(range(n), key=lambda i: -w[i])
        i = 0
        while sum(sizes) < rows:    # remainder rides the best destinations
            sizes[order[i % n]] += 1
            i += 1
        return sizes if min(sizes) >= self.min_rows else None

    def plan_tree(self, tree: Any,
                  weights: Optional[Sequence[float]] = None
                  ) -> Optional[ShardPlan]:
        """Multi-shard plan for a concrete argument tree, or ``None``
        when the call must pass through unsharded (unsplittable tree —
        rank-0 or row-misaligned leaves — or too few rows to clear the
        per-shard floor)."""
        rows = leading_rows(tree)
        if rows is None:
            return None
        plan = self.plan(rows, weights)
        return plan if plan.n_shards > 1 else None
