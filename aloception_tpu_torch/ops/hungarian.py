"""Hungarian assignment of set-prediction matching, on the device (counterpart
of ``aloception_tpu/ops/hungarian.py``).

``hungarian(cost, n_valid)`` solves a batch of rectangular assignments: the
CUDA kernel (``ops/cuda/hungarian_kernel.py``) for a CUDA tensor, the plain
version ``hungarian_torch`` for a CPU one. Both run the Jonker-Volgenant
shortest augmenting path algorithm in the e-maxx form the JAX package uses,
with the valid targets as rows and the queries as columns, in float32, with
the same operations in the same order, so they give the same assignment.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from .cuda.hungarian_kernel import hungarian_cuda


def jv_solve(a: np.ndarray) -> Tuple[np.ndarray, int]:
    """Minimum-cost assignment of every row of ``a`` (n, m), n <= m, float32,
    to a distinct column. Returns (column of each row, -1 where no column
    could be reached (NaN costs only), the number of augmenting steps).
    Argmin ties go to the lowest column."""
    a = np.ascontiguousarray(a, np.float32)
    n, m = a.shape
    if n > m:
        raise ValueError(f"{n} rows for {m} columns: needs rows <= columns")
    u = np.zeros(n + 1, np.float32)
    v = np.zeros(m + 1, np.float32)
    p = np.zeros(m + 1, np.int64)      # p[j]: row matched to column j, 0 free
    way = np.zeros(m + 1, np.int64)
    steps = 0
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, np.inf, np.float32)
        used = np.zeros(m + 1, bool)
        while True:
            steps += 1
            used[j0] = True
            i0 = p[j0]
            cur = (a[i0 - 1] - u[i0]) - v[1:]
            better = ~used[1:] & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            masked = np.where(used[1:], np.float32(np.inf), minv[1:])
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            if not delta < np.inf:        # no column left to reach
                j0 = -1
                break
            u[p[used]] += delta
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0 > 0:                     # unwind the augmenting path
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col = np.full(n, -1, np.int64)
    matched = np.nonzero(p[1:])[0]
    col[p[1:][matched] - 1] = matched
    return col, steps


def _as_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def hungarian_torch(cost: Union[torch.Tensor, np.ndarray],
                    n_valid: Union[torch.Tensor, np.ndarray]) -> torch.Tensor:
    """Plain version of ``hungarian_cuda``: cost (M, Nq, Nt), queries x
    targets; n_valid (M,). Returns (M, Nt) int32 on the CPU: for each valid
    target the query matched to it, -1 past n_valid."""
    cost = _as_numpy(cost).astype(np.float32, copy=False)
    n_valid = _as_numpy(n_valid)
    M, Nq, Nt = cost.shape
    if Nt > Nq:
        raise ValueError(f"{Nt} targets for {Nq} queries: the assignment "
                         "needs Nt <= Nq")
    out = np.full((M, Nt), -1, np.int32)
    for k in range(M):
        n = min(max(int(n_valid[k]), 0), Nt)
        if n:
            out[k, :n] = jv_solve(cost[k, :, :n].T)[0]
    return torch.from_numpy(out)


def hungarian(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """A CPU tensor takes the plain version; any other device takes the CUDA
    kernel, which raises on what it cannot run. No fallback."""
    if cost.device.type == "cpu":
        return hungarian_torch(cost, n_valid)
    return hungarian_cuda(cost.float().contiguous(),
                          n_valid.to(torch.int32).contiguous())
