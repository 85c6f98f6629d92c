"""Minimum-cost assignment in NumPy: the Hungarian method with potentials
(shortest augmenting paths, Kuhn-Munkres as Jonker and Volgenant write
it), O(n^2 m) for n rows and m >= n columns."""

from __future__ import annotations

import numpy as np


def assign(cost: np.ndarray) -> np.ndarray:
    """cost (n, m), n <= m -> the column given to each row, (n,) int64,
    such that the columns differ and their total cost is least."""
    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape
    if n > m:
        raise ValueError(f"{n} rows for {m} columns")
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    owner = np.zeros(m + 1, dtype=np.int64)     # row (1-based) of a column
    way = np.zeros(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        owner[0] = i
        j0 = 0
        minv = np.full(m + 1, np.inf)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = owner[j0]
            free = ~used[1:]
            cur = cost[i0 - 1] - u[i0] - v[1:]
            better = free & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            j1 = int(np.argmin(np.where(free, minv[1:], np.inf))) + 1
            delta = minv[j1]
            u[owner[used]] += delta
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if owner[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            owner[j0] = owner[j1]
            j0 = j1
    cols = np.empty(n, dtype=np.int64)
    for j in range(1, m + 1):
        if owner[j]:
            cols[owner[j] - 1] = j - 1
    return cols
