"""Spatial domain decomposition over a 3-D device mesh.

The reference splits the lattice into Dx x Dy x Dz per-GPU subdomains with
1-cell halos and hand-rolled pack/PCIe/unpack halo exchange every step
(reference: lbm.cpp:1067-1125, 1864-1958; kernel.cpp:2259-2378).  Here the
whole layer collapses into GSPMD: lattice arrays are sharded over a
`jax.sharding.Mesh` with axes ('z','y','x'), the step function is `jit`ed
with sharding annotations, and XLA inserts the halo `collective-permute`s for
the shifted reads over ICI automatically — including compute/communication
overlap the reference never attempts.

The deck key `n_gpu = [Dx, Dy, Dz]` maps directly to the mesh shape.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..lbm.state import LBMState


def ensure_distributed() -> bool:
    """Initialize jax.distributed for multi-host (DCN) pods when the
    standard coordination env is present (LUW_COORDINATOR or the JAX
    defaults COORDINATOR_ADDRESS/+NUM_PROCESSES/PROCESS_ID).  Idempotent;
    single-host runs are untouched.  Returns True when running multi-host.

    The reference is single-process multi-GPU only (SURVEY §5: PCIe host
    pointer swaps); pods shard the same ('z','y','x') mesh over all global
    devices — the outer z axis naturally lands across hosts so the per-step
    plane halos ride DCN while y/x ghost traffic stays on ICI.
    """
    import os

    coord = os.environ.get("LUW_COORDINATOR") or os.environ.get(
        "COORDINATOR_ADDRESS")
    if not coord:
        return False
    # probe initialization WITHOUT jax.process_count(): that call would
    # initialize the XLA backend, after which jax.distributed.initialize
    # refuses to run (caught by tests/test_distributed.py)
    if jax.distributed.is_initialized():
        return jax.process_count() > 1
    kw = {"coordinator_address": coord}
    if os.environ.get("LUW_NUM_PROCESSES"):
        kw["num_processes"] = int(os.environ["LUW_NUM_PROCESSES"])
        kw["process_id"] = int(os.environ.get("LUW_PROCESS_ID", "0"))
    jax.distributed.initialize(**kw)
    return jax.process_count() > 1


def domain_mesh(split: Tuple[int, int, int], devices=None) -> Mesh:
    """Mesh over ('z','y','x') from the deck's [Dx, Dy, Dz] split triple.

    Note the deck order is (Dx, Dy, Dz); arrays are indexed [z, y, x].
    Multi-host pods: set LUW_COORDINATOR (see ensure_distributed) and the
    mesh builds over the GLOBAL device set in process order, so contiguous
    z-slabs map host-local first (halo traffic prefers ICI).
    """
    dx, dy, dz = split
    if devices is None:
        ensure_distributed()
        devices = jax.devices()
    n = dx * dy * dz
    if len(devices) < n:
        raise ValueError(f"need {n} devices for split {split}, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(dz, dy, dx)
    return Mesh(dev, axis_names=("z", "y", "x"))


def _scalar_spec() -> P:
    return P("z", "y", "x")


def _vector_spec() -> P:
    return P(None, "z", "y", "x")


def state_sharding(mesh: Mesh, thermal: bool) -> LBMState:
    """Pytree of NamedShardings matching LBMState's layout."""
    s = NamedSharding(mesh, _scalar_spec())
    v = NamedSharding(mesh, _vector_spec())
    return LBMState(
        fi=v, rho=s, u=v, flags=s,
        gi=v if thermal else None,
        T=s if thermal else None,
    )


def shard_state(state: LBMState, mesh: Mesh) -> LBMState:
    """Place a (host or single-device) state onto the mesh."""
    shardings = state_sharding(mesh, thermal=state.gi is not None)
    return jax.tree.map(
        lambda x, sh: jax.device_put(x, sh) if x is not None else None,
        state, shardings,
        is_leaf=lambda x: x is None,
    )
