"""Device mesh + sharding policy.

The reference has no distributed layer (rayon only; SURVEY.md §2.8) — this
is the first-class new component: a flat 1-D `rows` mesh over the first n
devices JAX lists shards the evaluation domain (rows of the 2^k table, MSM
points, NTT halves).  No device order is preferred: on the H100 the cards of
one host are joined all to all by NVLink.  XLA/GSPMD inserts the collectives
(halo exchange for rotations, all-to-all for NTT stages, psum for
log-derivative sums); the MSM gathers its per-device window totals and
combines them on the host (`ops/msm.msm_sharded`).  The transcript
RO stays on the host controller so absorb/squeeze order is device-count
invariant (SURVEY.md §5).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROWS_AXIS = "rows"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (ROWS_AXIS,))


def row_sharding(mesh: Mesh, axis: int, ndim: int) -> NamedSharding:
    """Shard dimension `axis` of an ndim-array over the rows mesh axis."""
    spec = [None] * ndim
    spec[axis] = ROWS_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_rows(mesh: Mesh, x, axis: int = 0):
    """Place an array with its `axis` dimension sharded across the mesh."""
    return jax.device_put(x, row_sharding(mesh, axis, x.ndim))
