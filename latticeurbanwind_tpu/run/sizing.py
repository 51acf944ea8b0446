"""Grid sizing: cell size from a device-memory budget + sponge grid extension.

Re-model of the reference's VRAM-driven resolution fit
(reference: setup.cpp:371-407 fit_cell_size_to_gpu_memory_request,
setup.cpp:3552-3568 top-sponge grid extension).  The byte model counts
this framework's device arrays at the step's peak instead of the OpenCL
buffer set, for the step tier the run takes (`bytes_per_cell`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


# What the jnp step holds beyond its input and output state (decoded and
# streamed DDFs, equilibria), B/cell: the temporaries of XLA's memory
# analysis of the step loop with the deck physics at 64x256x256 on an H100,
# less the output buffers the kernel also holds.  Thermal was measured in
# f32 and bf16; f16 and fp16c take the bf16 figure.
JNP_STEP_EXTRA = {"f32": 158, "bf16": 154, "f16": 146, "fp16c": 124}
JNP_THERMAL_EXTRA = {"f32": 127, "bf16": 136, "f16": 136, "fp16c": 136}


def bytes_per_cell(storage: str = "f16", thermal: bool = False,
                   tier: str = "reference") -> float:
    """Peak device bytes per cell of a deck run stepping `tier` ("pallas":
    the fused kernel; "reference": the jnp step, see `sizing_tier`).

    The step reads one DDF set and writes another (2 x 19 x s) and the same
    for rho/u (2 x 16); flags (1), nudge sigma + face id (5) and the Welford
    accumulators mean_u, M2, mean_rho (20) stay resident.  Thermal adds the
    D3Q7 pair, T in and out, and mean_T.  The jnp step adds its
    intermediates.  An H100 deck run on the kernel at 1.74e8 cells in bf16
    peaked at 134.2 B/cell (`peak_bytes_in_use`), against 134 here."""
    s = {"f32": 4, "f16": 2, "bf16": 2, "fp16c": 2}[storage]
    total = 19 * s * 2 + (4 + 12) * 2 + 1 + 5 + 20
    if thermal:
        total += 7 * s * 2 + 4 * 2 + 4
    if tier == "reference":
        total += (JNP_THERMAL_EXTRA if thermal else JNP_STEP_EXTRA)[storage]
    elif tier != "pallas":
        raise ValueError(f"unknown tier {tier!r}")
    return float(total)


def sizing_tier(impl: str, thermal: bool, n_devices: int) -> str:
    """The tier a deck run will step, resolved before its case is built:
    `lbm.stepper.select_impl` on one device; an n_gpu split steps the jnp
    tier under GSPMD."""
    from ..lbm.state import StepConfig
    from ..lbm.stepper import select_impl

    if n_devices > 1:
        return "reference"
    return select_impl(StepConfig(omega=1.0, thermal=thermal), impl)


@dataclass(frozen=True)
class GridPlan:
    cell_m: float
    nx: int
    ny: int
    nz_core: int
    nz: int                  # core + sponge extension rows
    sponge_cells: int
    sponge_extended: bool
    side_ref_z_cap: int      # top of the core region (-1 when no extension)
    bytes_per_device: int
    n_devices: int


def _grid_dims(si_size, cell_m: float, sponge_thickness_m: float,
               sponge_enabled: bool) -> Tuple[int, int, int, int, bool]:
    nx = max(1, int(si_size[0] / cell_m + 0.5))
    ny = max(1, int(si_size[1] / cell_m + 0.5))
    nz_core = max(1, int(si_size[2] / cell_m + 0.5))
    sponge_cells = max(1, int(round(sponge_thickness_m / cell_m)))
    extend = sponge_enabled and nz_core > 2
    nz = nz_core + (sponge_cells if extend else 0)
    return nx, ny, nz_core, nz, extend


def plan_grid(
    si_size: Tuple[float, float, float],
    *,
    cell_m: Optional[float] = None,
    memory_mb: Optional[int] = None,
    n_devices: int = 1,
    storage: str = "f16",
    thermal: bool = False,
    sponge_thickness_m: float = 0.0,
    sponge_enabled: bool = False,
    tier: str = "reference",
) -> GridPlan:
    """Resolve the lattice dimensions from either an explicit cell size or a
    per-device memory budget (bisection, like the reference's mesh_control).
    `tier` is the step the run takes (`sizing_tier`).
    """
    bpc = bytes_per_cell(storage, thermal, tier)

    def device_bytes(cm: float) -> int:
        nx, ny, _, nz, _ = _grid_dims(si_size, cm, sponge_thickness_m, sponge_enabled)
        cells = nx * ny * nz
        return int(cells * bpc / max(1, n_devices))

    if cell_m is None:
        if not memory_mb or memory_mb <= 0:
            cell_m = 20.0
        else:
            budget = memory_mb * 1024 * 1024
            lo = 0.5   # finest cell we'd ever fit
            hi = max(max(si_size), 1.0)
            while device_bytes(hi) > budget and hi < 1e6:
                hi *= 2.0
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                if device_bytes(mid) <= budget:
                    hi = mid
                else:
                    lo = mid
            cell_m = hi

    nx, ny, nz_core, nz, extended = _grid_dims(
        si_size, cell_m, sponge_thickness_m, sponge_enabled)
    sponge_cells = max(1, int(round(sponge_thickness_m / cell_m)))
    return GridPlan(
        cell_m=float(cell_m),
        nx=nx, ny=ny, nz_core=nz_core, nz=nz,
        sponge_cells=sponge_cells,
        sponge_extended=extended,
        side_ref_z_cap=(nz_core - 1) if extended else -1,
        bytes_per_device=device_bytes(cell_m),
        n_devices=n_devices,
    )
