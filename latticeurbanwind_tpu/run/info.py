"""Console status: MLUPs / bandwidth model / two-phase ETA.

Clean-room equivalent of the reference Info struct (info.hpp:7-38,
info.cpp:74-140): smoothed steps/s and MLUPs, a bytes-per-cell bandwidth
model for the configured storage, and the two-phase ETA that separately
tracks normal-phase and averaging-phase step costs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


def bytes_per_cell_update(storage: str = "bf16", thermal: bool = False,
                          impl: str = "reference") -> float:
    """Least device-memory bytes per cell update of the tier stepped.

    Both tiers read and write every DDF once and read the flags byte (the
    reference's own model, lbm.cpp:121-142), and write the fresh f32 rho/u
    (16 B).  The jnp tier ("reference") also reads the previous rho/u
    everywhere (16 B); the fused kernel ("pallas") reads them only at
    boundary cells.  Thermal steps (jnp tier only) add the D3Q7 DDFs and
    a T read and write."""
    s = {"f32": 4, "f16": 2, "fp16c": 2, "bf16": 2}[storage]
    total = 19 * s * 2 + 1 + 16
    if impl != "pallas":
        total += 16
    if thermal:
        total += 7 * s * 2 + 8
    return float(total)


@dataclass
class RunInfo:
    """Two-phase step-cost tracker and ETA."""

    total_steps: int
    avg_start: int = 0                      # first averaged step (0 = none)
    n_cells: int = 0
    storage: str = "bf16"
    thermal: bool = False
    impl: str = "reference"                 # tier stepped (traffic model)
    smoothing: float = 0.2                  # EMA factor

    normal_s_per_step: float = 0.0
    avg_s_per_step: float = 0.0
    _last_t: Optional[int] = None
    _last_wall: Optional[float] = None

    def start(self, t: int) -> None:
        self._last_t = t
        self._last_wall = time.perf_counter()

    def update(self, t: int) -> None:
        now = time.perf_counter()
        if self._last_t is None or t <= self._last_t:
            self._last_t, self._last_wall = t, now
            return
        per_step = (now - self._last_wall) / (t - self._last_t)
        in_avg = self.avg_start and t > self.avg_start
        if in_avg:
            self.avg_s_per_step = (per_step if self.avg_s_per_step == 0 else
                                   (1 - self.smoothing) * self.avg_s_per_step
                                   + self.smoothing * per_step)
        else:
            self.normal_s_per_step = (per_step if self.normal_s_per_step == 0 else
                                      (1 - self.smoothing) * self.normal_s_per_step
                                      + self.smoothing * per_step)
        self._last_t, self._last_wall = t, now

    def steps_per_second(self, phase: str = "normal") -> float:
        sps = self.normal_s_per_step if phase == "normal" else self.avg_s_per_step
        return 1.0 / sps if sps > 0 else 0.0

    def mlups(self, phase: str = "normal") -> float:
        return self.n_cells * self.steps_per_second(phase) / 1e6

    def bandwidth_gbps(self, phase: str = "normal") -> float:
        return self.mlups(phase) * bytes_per_cell_update(
            self.storage, self.thermal, self.impl) / 1e3

    def eta_seconds(self, t: int) -> float:
        """Remaining wall time with separate phase costs (two-phase model)."""
        if self.avg_start and t < self.avg_start:
            normal_left = self.avg_start - t
            avg_left = self.total_steps - self.avg_start
        elif self.avg_start:
            normal_left = 0
            avg_left = self.total_steps - t
        else:
            normal_left = self.total_steps - t
            avg_left = 0
        n_cost = self.normal_s_per_step
        a_cost = self.avg_s_per_step or n_cost
        return max(0.0, normal_left * n_cost + avg_left * a_cost)

    def timing_plan(self, impl: str) -> str:
        line = (f"| LBM TIMING PLAN | impl={impl} "
                f"normal {self.steps_per_second():.1f} steps/s "
                f"({self.mlups():.0f} MLUPs, ~{self.bandwidth_gbps():.0f} GB/s)")
        if self.avg_s_per_step > 0:
            line += (f", averaging {self.steps_per_second('avg'):.1f} steps/s")
        return line
