"""The spread of a metric over repeated runs of one cell.

- `iqr_share`: the distance between the first and the third quartile
  (statistics.quantiles(values, n=4)) as a share of the median: the
  spread a bound is set from (about five times the widest, never under
  1 %), and the one a bound is too loose against (over eight times it).
- `trimmed_range_share`: the range, less the run farthest from the
  median where that narrows it, as a share of the median: the check's
  reading of a bound's tightness (the mean of two sets' may be at most
  half the bound).
"""

from __future__ import annotations

import statistics


def _share(width: float, values) -> float:
    """width over the median; a metric whose median is 0 has no share
    but 0 where it does not move at all."""
    med = statistics.median(values)
    if med == 0:
        return 0.0 if width == 0 else float("inf")
    return width / med


def iqr_share(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return _share(q3 - q1, values)


def _trimmed(values):
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def trimmed_range_share(values) -> float:
    width = max(values) - min(values)
    if len(values) >= 3:
        rest = _trimmed(values)
        width = min(width, max(rest) - min(rest))
    return _share(width, values)
