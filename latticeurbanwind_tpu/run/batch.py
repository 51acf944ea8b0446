"""Case-parallel batch execution: shard the CASE axis over the device mesh.

The reference runs its .luwdg / .luwpf batches strictly serially — a new
LBM instance per (inflow, angle) case on the same GPUs
(setup.cpp:5690-5753, 5997-6145).  Here the cases of a dataset sweep are
embarrassingly parallel: each device holds ONE case's full lattice and steps
it with the SAME single-device step, so a 16-direction wind-rose sweep on 16
devices finishes in the wall-clock of one case — with no inter-device
communication during stepping.

Mechanics (`run_cases_case_parallel`):
  * cases are grouped into batches of D = min(n_devices, n_cases); per-case
    arrays (DDFs, fields, flags, nudge fields) are stacked on a leading
    `case` axis sharded over a 1-D ``Mesh(('case',))``,
  * one `shard_map` jit runs the WHOLE loop per case — phase A plain
    stepping, phase B the Welford averaging window sampled every
    `purge_avg_stride` steps (device-side, like the serial driver) — so
    there is exactly one compile for the whole sweep and no host round
    trips between steps,
  * inside the per-case body the single-device step the backend selects
    (lbm/stepper.select_impl) is built with the case's OWN forcing arrays
    as traced inputs, so per-angle downstream-face differences do not
    multiply compilations,
  * finalize (avg VTK with tke/TI/TLS, raw u/rho) reuses the serial
    driver's `write_final_outputs`, so outputs have the same files, names,
    fields, and formats as a serial run of the same deck (values agree to
    fp32 tolerance — the shard_map compilation may reorder reductions;
    tests/test_case_parallel.py pins rtol 2e-4).

Opt in with the deck extension key `case_parallel = true` (run/modes.py).
Cases with probes, unsteady/frame outputs, checkpointing, a VK inlet
pre-step, or thermal physics fall back to the serial driver (the batch
runner refuses, run_cases dispatches serially) — those features need the
event loop.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..lbm.state import Forcing, LBMState
from .driver import (
    DEFAULT_RUN_STEPS, RunResult, SolverCase, write_final_outputs,
)
from .welford import AvgState

__all__ = ["case_parallel_unsupported", "run_cases_case_parallel"]


def case_parallel_unsupported(cases: Sequence[SolverCase]) -> Optional[str]:
    """Why this batch cannot run case-parallel (None = it can)."""
    if len(cases) < 2:
        return "fewer than two cases"
    c0 = cases[0]
    if c0.config.thermal:
        return "thermal cases need the serial event loop"
    for c in cases:
        if c.probes:
            return "probe sampling needs the serial event loop"
        if c.pre_step is not None:
            return "VK inlet pre-step needs the serial event loop"
        s = c.settings
        total = (s.run_nstep if s.run_nstep > 0 else DEFAULT_RUN_STEPS) \
            + max(s.research_output, 0)
        fires = [v for v in (s.unsteady_output, s.frame_output,
                             s.checkpoint_interval) if 0 < v <= total]
        if fires:
            return "unsteady/frame/checkpoint events need the serial driver"
        if c.config != c0.config:
            return "cases differ in StepConfig (storage/omega/...)"
        if c.state.rho.shape != c0.state.rho.shape:
            return "cases differ in grid shape"
        if (c.forcing.nudge_sigma is None) != (c0.forcing.nudge_sigma is None) \
                or (c.forcing.sponge_sigma_z is None) != (c0.forcing.sponge_sigma_z is None):
            return "cases differ in forcing structure"
        if int(np.prod(c.ngpu)) > 1:
            return "n_gpu spatial split requested (use one device per case)"
        # dyn is applied from case 0 for the whole batch — refuse divergence
        # instead of silently replacing it (per-case dyn would need to be a
        # stacked input like the forcing arrays)
        if (c.dyn is None) != (c0.dyn is None) or (
                c.dyn is not None and not (
                    np.array_equal(np.asarray(c.dyn.force),
                                   np.asarray(c0.dyn.force))
                    and np.array_equal(np.asarray(c.dyn.omega_coriolis),
                                       np.asarray(c0.dyn.omega_coriolis)))):
            return "cases differ in dynamic parameters (force/Coriolis)"
    return None


def run_cases_case_parallel(cases: Sequence[SolverCase], *,
                            impl: str = "auto", quiet: bool = False,
                            ) -> List[RunResult]:
    """Run same-shape cases with the case axis sharded over the devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    reason = case_parallel_unsupported(cases)
    if reason:
        raise ValueError(f"case-parallel unsupported: {reason}")

    c0 = cases[0]
    cfg = c0.config
    s = c0.settings
    shape = c0.state.rho.shape
    total_steps = (s.run_nstep if s.run_nstep > 0 else DEFAULT_RUN_STEPS) \
        + max(s.research_output, 0)
    avg_window = min(s.purge_avg, total_steps) if s.purge_avg > 0 else 0
    avg_stride = max(1, s.purge_avg_stride)
    avg_start = total_steps - avg_window + 1 if avg_window else 0
    n_samples = ((total_steps - avg_start) // avg_stride + 1) if avg_window else 0
    tail = total_steps - (avg_start + (n_samples - 1) * avg_stride) \
        if avg_window else total_steps

    has_nudge = c0.forcing.nudge_sigma is not None
    has_sponge = c0.forcing.sponge_sigma_z is not None

    devices = jax.devices()
    D = min(len(devices), len(cases))
    mesh = Mesh(np.array(devices[:D]), ("case",))

    from ..lbm.stepper import make_step_fn, select_impl

    tier = select_impl(cfg, impl)
    if not quiet:
        print(f"| Case-parallel   | {len(cases)} cases over {D} device(s), "
              f"tier={tier}, {total_steps} steps "
              f"(avg window {avg_window} @ stride {avg_stride})")

    def body(fi, rho, u, flags, nsig, nface, ssig, dyn):
        """Per-device: simulate ONE case end-to-end (leading axis size 1)."""
        state = LBMState(fi=fi[0], rho=rho[0], u=u[0], flags=flags[0],
                         gi=None, T=None)
        forcing = Forcing(
            nudge_sigma=nsig[0] if has_nudge else None,
            nudge_face=nface[0] if has_nudge else None,
            nudge_vertical=c0.forcing.nudge_vertical,
            sponge_sigma_z=ssig[0] if has_sponge else None)

        step = make_step_fn(cfg, forcing, tier)

        def advance(carry, n):
            return jax.lax.fori_loop(
                0, n, lambda i, st: step(st, dyn), carry)

        sim = advance(state, avg_start - 1 if avg_window else total_steps)
        if avg_window:
            from .welford import init_avg, welford_update

            avg = init_avg(shape, thermal=False)

            def sample(i, carry):
                sim, avg = carry
                sim = advance(sim, avg_stride)
                avg = welford_update(avg, sim)
                return sim, avg

            # first sample lands at avg_start: one more step from avg_start-1
            sim = advance(sim, 1)
            avg = welford_update(avg, sim)
            sim, avg = jax.lax.fori_loop(0, n_samples - 1, sample, (sim, avg))
            if tail > 0:
                sim = advance(sim, tail)
        else:
            avg = jnp.zeros((), jnp.float32)   # placeholder, ignored
        return (jax.tree.map(lambda a: a[None], sim),
                jax.tree.map(lambda a: a[None], avg))

    from jax.experimental.shard_map import shard_map

    spec_case = P("case")
    sharded = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(spec_case,) * 7 + (P(),),
        out_specs=(spec_case, spec_case),
        check_rep=False))

    def stack(getter, dtype=None):
        arrs = [np.asarray(getter(c)) for c in batch]
        out = np.stack(arrs)
        return out if dtype is None else out.astype(dtype)

    results: List[RunResult] = []
    zeros = np.zeros((1,), np.float32)   # placeholder for absent forcing
    for b0 in range(0, len(cases), D):
        batch = list(cases[b0:b0 + D])
        pad = D - len(batch)
        batch = batch + [batch[-1]] * pad
        t0 = time.perf_counter()
        fi = stack(lambda c: c.state.fi)
        rho = stack(lambda c: c.state.rho)
        uu = stack(lambda c: c.state.u)
        fl = stack(lambda c: c.state.flags)
        nsig = stack(lambda c: c.forcing.nudge_sigma) if has_nudge \
            else np.broadcast_to(zeros, (D, 1))
        nface = stack(lambda c: c.forcing.nudge_face) if has_nudge \
            else np.broadcast_to(zeros, (D, 1))
        ssig = stack(lambda c: c.forcing.sponge_sigma_z) if has_sponge \
            else np.broadcast_to(zeros, (D, 1))

        put = lambda a: jax.device_put(  # noqa: E731
            a, NamedSharding(mesh, P("case")))
        final, avg = sharded(put(fi), put(rho), put(uu), put(fl),
                             put(nsig), put(nface), put(ssig), batch[0].dyn)
        jax.block_until_ready(final.rho)
        secs = time.perf_counter() - t0
        per_case = secs / max(len(batch) - pad, 1)
        if not quiet:
            mlups = (np.prod(shape) * total_steps * (len(batch) - pad)
                     / max(secs, 1e-9) / 1e6)
            note = " incl. compile" if b0 == 0 else ""
            print(f"| Case-parallel   | batch of {len(batch) - pad}: "
                  f"{secs:.1f} s total ({mlups:.0f} MLUPs aggregate{note})")

        for ci, case in enumerate(batch[:len(batch) - pad]):
            st = jax.tree.map(lambda a: np.asarray(a[ci]), final)
            state = LBMState(fi=st.fi, rho=st.rho, u=st.u,
                             flags=st.flags, gi=None, T=None)
            avg_c = None
            if avg_window:
                avg_c = AvgState(
                    count=np.asarray(avg.count[ci]),
                    mean_u=np.asarray(avg.mean_u[ci]),
                    m2_u=np.asarray(avg.m2_u[ci]),
                    mean_rho=np.asarray(avg.mean_rho[ci]), mean_T=None)
            files: List[Path] = []
            write_final_outputs(case, state, avg_c, n_samples, total_steps,
                                files)
            results.append(RunResult(
                state=state, avg=avg_c, total_steps=total_steps,
                solver_seconds=per_case, files=files,
                timing={"solver_seconds": per_case,
                        "case_parallel_batch": float(len(batch) - pad)}))
    return results
