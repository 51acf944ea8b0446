"""Brute-force nearest-neighbor inlet interpolation — the low-order BC path.

Clean-room equivalent of the reference NearestNeighborInterpolator
(reference: interpolation.cpp:51-60, apply_inlet_outlet :68-180).  Here the
all-pairs distance search is a chunked matmul (|q-s|^2 = |q|^2 + |s|^2 - 2 q.s)
followed by an argmin — matmul-shaped instead of the reference's per-cell
scalar loop over every sample.
"""

from __future__ import annotations

import numpy as np


def nearest_neighbor_eval(points: np.ndarray, values: np.ndarray,
                          queries: np.ndarray, *, chunk: int = 65536,
                          use_jax: bool = True) -> np.ndarray:
    """values[argmin_s |query - point_s|] for each query.

    points (S,3), values (S,C), queries (Q,3) -> (Q,C).
    """
    points = np.asarray(points, dtype=np.float32)
    values = np.asarray(values)
    queries = np.asarray(queries, dtype=np.float32)
    if len(points) == 0:
        return np.zeros((len(queries), values.shape[1] if values.ndim > 1 else 1))

    if use_jax:
        try:
            return _nearest_jax(points, values, queries, chunk)
        except Exception:
            pass
    out_idx = np.empty(len(queries), dtype=np.int64)
    s_norm = (points ** 2).sum(axis=1)
    for start in range(0, len(queries), chunk):
        q = queries[start:start + chunk]
        d2 = (q ** 2).sum(axis=1)[:, None] + s_norm[None] - 2.0 * q @ points.T
        out_idx[start:start + len(q)] = d2.argmin(axis=1)
    return values[out_idx]


def _nearest_jax(points, values, queries, chunk):
    import jax
    import jax.numpy as jnp

    pts = jnp.asarray(points)
    s_norm = jnp.sum(pts * pts, axis=1)

    @jax.jit
    def block(q):
        d2 = jnp.sum(q * q, axis=1)[:, None] + s_norm[None] - 2.0 * q @ pts.T
        return jnp.argmin(d2, axis=1)

    idx = np.empty(len(queries), dtype=np.int64)
    n = len(queries)
    for start in range(0, n, chunk):
        q = queries[start:start + chunk]
        pad = chunk - len(q)
        if pad:
            q = np.pad(q, ((0, pad), (0, 0)))
        got = np.asarray(block(jnp.asarray(q)))
        idx[start:start + min(chunk, n - start)] = got[: min(chunk, n - start)]
    return values[idx]
