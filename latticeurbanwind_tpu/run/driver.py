"""Solver run driver: the equivalent of the reference's run_lbm loop
(setup.cpp:4117-4911).

Responsibilities:
  * step the lattice in jit-compiled scan chunks (few distinct chunk lengths
    to bound compile count),
  * Welford mean/variance accumulation over the final `purge_avg` window at
    `purge_avg_stride` — on device (the reference reads fields back to the
    host per sample),
  * unsteady u VTK snapshots every `unsteady_output` steps,
  * probe column sampling over the probe window,
  * two-phase timing plan (normal vs averaging phase step cost) + ETA,
  * finalize: transient u/rho/T VTKs, `<prefix><datetime>_avg-<t>.vtk` with
    u_avg/rho_avg[/T_avg]/fluid + tke/TI/TLS, probe CSVs, transform.info.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.progress import ProgressEmitter
from ..io.vtk import write_structured_points
from ..lbm.state import DynParams, Forcing, LBMState, StepConfig
from ..lbm.stepper import make_runner
from ..units import Units
from .derived import derived_turbulence_fields
from .info import RunInfo
from .probes import GridProbe
from .welford import AvgState, init_avg, variance_sum_u, welford_update

DEFAULT_RUN_STEPS = 20001


def vtk_timestep_name(name: str, t: int) -> str:
    """`<name>-<9-digit t>.vtk` (reference default_filename, lbm.cpp:235)."""
    return f"{name}-{t:09d}.vtk"


@dataclass
class RunSettings:
    run_nstep: int = 0                 # 0 -> default 20001
    research_output: int = 0
    unsteady_output: int = 0
    purge_avg: int = 0
    purge_avg_stride: int = 1
    output_fields: Tuple[str, ...] = ("tke", "ti", "tls")
    chunk: int = 50                    # max steps per compiled scan chunk
    checkpoint_interval: int = 0       # save state every N steps (0 = off)
    resume: bool = True                # resume from an existing checkpoint
    snapshots: bool = True             # render PNG snapshots at unsteady events
    frame_output: int = 0              # perspective video frame every N steps


@dataclass
class SolverCase:
    """Everything needed to run one LBM case."""

    config: StepConfig
    forcing: Forcing
    state: LBMState
    dyn: DynParams
    units: Units
    cell_m: float
    parent: Path
    datetime: str
    vtk_prefix: str = ""
    nz_out: int = 0                    # crop output above this (sponge rows)
    settings: RunSettings = field(default_factory=RunSettings)
    probes: List[GridProbe] = field(default_factory=list)
    thermal_output: bool = False       # include T in outputs/averaging
    origin_shift: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    impl: str = "auto"
    pre_step: Optional[object] = None  # callable (state, t) -> state (VK inlet)
    ngpu: Tuple[int, int, int] = (1, 1, 1)  # deck n_gpu -> device-mesh split


@dataclass
class RunResult:
    state: Optional[LBMState]
    avg: Optional[AvgState]
    total_steps: int
    solver_seconds: float
    files: List[Path]
    timing: Dict[str, float]

    def release_device_state(self) -> None:
        """Drop the device-resident final state + Welford accumulator.

        A completed case pins ~2.5 GB of device memory per 30M cells through
        these references; serial multi-case batches (.luwpf angle sweeps,
        .luwdg matrices) must release each case before solving the next or
        a production sweep exhausts the device memory.  The
        batch loops keep only the final case's state (single-case runs are
        unaffected); everything user-facing is already on disk in
        `files`/`timing`."""
        self.state = None
        self.avg = None


def _sync(state: LBMState) -> None:
    import jax.numpy as jnp

    float(jnp.asarray(state.rho[0, 0, 0]))


class _PngOutput:
    """PNG snapshots and frames need matplotlib, which the solver does not:
    without it they are skipped, with one notice (VTK output unaffected)."""

    def __init__(self):
        self._ok = None

    def ok(self) -> bool:
        if self._ok is None:
            import importlib.util

            self._ok = importlib.util.find_spec("matplotlib") is not None
            if not self._ok:
                print("| Snapshots       | matplotlib is not installed: PNG "
                      "snapshots and frames skipped (VTK output unaffected)")
        return self._ok


def run_case(case: SolverCase, *, quiet: bool = False) -> RunResult:
    import jax.numpy as jnp

    s = case.settings
    total_steps = (s.run_nstep if s.run_nstep > 0 else DEFAULT_RUN_STEPS) + max(s.research_output, 0)
    avg_window = min(s.purge_avg, total_steps) if s.purge_avg > 0 else 0
    avg_stride = max(1, s.purge_avg_stride)
    avg_start = total_steps - avg_window + 1 if avg_window else total_steps + 1
    unsteady = max(0, s.unsteady_output)
    frames = max(0, s.frame_output)
    probe_window = avg_window if case.probes else 0
    probe_start = total_steps - probe_window + 1 if probe_window else total_steps + 1

    shape = case.state.rho.shape
    progress = ProgressEmitter("solve")
    files: List[Path] = []

    # --- device mesh (deck n_gpu = [Dx, Dy, Dz]) ---------------------------
    # Multi-device runs shard the lattice over a device mesh (the reference's
    # domain-split + halo pipeline, lbm.cpp:1067-1958, collapses into
    # sharded-array semantics): GSPMD partitions the jnp step and XLA
    # inserts the halo collectives.  The fused kernel is single-device.
    mesh = None
    impl = case.impl
    ndev = int(np.prod(case.ngpu))
    if ndev > 1:
        import jax

        if len(jax.devices()) >= ndev:
            from ..parallel import domain_mesh

            mesh = domain_mesh(tuple(case.ngpu))
            if impl == "pallas":
                raise ValueError("impl='pallas' steps one device; an n_gpu "
                                 "split runs the GSPMD jnp tier")
            impl = "reference"
            if not quiet:
                print(f"| Device mesh     | n_gpu={list(case.ngpu)} -> "
                      f"{ndev}-device mesh (GSPMD)")
        elif not quiet:
            print(f"| Device mesh     | n_gpu={list(case.ngpu)} requested, "
                  f"{len(jax.devices())} device(s) visible — single-device run")

    # ONE runner with a traced trip count serves every chunk length — the
    # event schedule produces irregular chunk sizes, and a static-length
    # loop would recompile the step per distinct size.
    advance, impl_name = make_runner(
        case.config, case.forcing, n_inner=1, impl=impl, donate=True,
        pre_step=case.pre_step)
    if not quiet:
        print(f"| Step tier       | {impl_name}")

    def runner(n: int):
        return lambda st, dyn, t: advance(st, dyn, t, n)

    # event times where we must stop stepping
    events = set()
    if unsteady:
        events.update(range(unsteady, total_steps + 1, unsteady))
    if frames:
        events.update(range(frames, total_steps + 1, frames))
    if avg_window:
        events.update(range(avg_start, total_steps + 1, avg_stride))
    if probe_window:
        events.update(range(probe_start, total_steps + 1, avg_stride))
    if s.checkpoint_interval > 0:
        events.update(range(s.checkpoint_interval, total_steps + 1,
                            s.checkpoint_interval))
    events.add(total_steps)
    event_list = sorted(events)

    state = case.state
    avg = init_avg(shape, case.thermal_output) if avg_window else None
    avg_samples = 0
    resume_t = 0
    ckpt_path = None
    if s.checkpoint_interval > 0:
        from .checkpoint import checkpoint_path, load_checkpoint, save_checkpoint

        ckpt_path = checkpoint_path(case.parent, case.datetime, case.vtk_prefix)
        if s.resume and ckpt_path.exists():
            try:
                state, resume_t, avg_loaded, avg_samples, _ = load_checkpoint(
                    ckpt_path, expect_shape=shape, probes=case.probes)
                if avg_loaded is not None:
                    avg = avg_loaded
                if not quiet:
                    print(f"| Checkpoint      | resumed from step {resume_t}")
            except (ValueError, KeyError, OSError) as e:
                print(f"| Checkpoint      | ignoring unreadable checkpoint: {e}")
                resume_t = 0

    if mesh is not None:
        from ..parallel import shard_state

        state = shard_state(state, mesh)
    elif resume_t:
        # checkpoint loads return HOST arrays (so sharded resumes never
        # materialize the global state on one device); commit the
        # single-device case up front to keep step donation effective
        import jax

        state = jax.device_put(state)
    if resume_t and avg is not None:
        # same for the restored accumulator: welford_update donates it
        from .welford import place_avg

        avg = place_avg(avg, mesh)

    u_factor = case.units.si_u(1.0)
    rho_factor = case.units.si_rho(1.0)
    dt_si = case.units.si_t(1)
    vtk_dir = case.parent / "RESULTS" / "vtk"
    raw_base = f"{case.vtk_prefix}{case.datetime}_raw_"

    def write_raw(name: str, data: np.ndarray, t: int, affine_T: bool = False):
        arr = np.asarray(data)
        if affine_T:
            arr = arr * case.units.unit_K + case.units.unit_K_offset
        path = vtk_dir / vtk_timestep_name(raw_base + name, t)
        write_structured_points(
            path, {"data": arr.astype(np.float32)},
            spacing=case.cell_m, origin_shift=case.origin_shift,
            nz_write=case.nz_out,
        )
        files.append(path)
        return path

    # --- timing plan: normal benchmark ------------------------------------
    info = RunInfo(total_steps=total_steps,
                   avg_start=avg_start if avg_window else 0,
                   n_cells=int(np.prod(shape)),
                   storage=case.config.storage,
                   thermal=case.config.thermal, impl=impl_name)

    t = resume_t
    t0 = time.perf_counter()
    next_events = [e for e in event_list if e > t]
    avail = (next_events[0] if next_events else total_steps) - t
    bench_steps = 0 if t else min(16, avail // 2, total_steps)
    info.start(t)
    calibrated = False
    if bench_steps > 0:
        # first batch warms up (jit compile) so the calibration batch times
        # pure stepping — the reference's OpenCL program is likewise compiled
        # before its 16-step benchmark (setup.cpp:4799-4841).  Both batches
        # use the same runner length, so no extra compilation happens.
        w0 = time.perf_counter()
        state = runner(bench_steps)(state, case.dyn, t)
        _sync(state)
        t_warm = time.perf_counter() - w0
        t += bench_steps
        info.start(t)
        w0 = time.perf_counter()
        state = runner(bench_steps)(state, case.dyn, t)
        _sync(state)
        t_bench = time.perf_counter() - w0
        t += bench_steps
        info.update(t)
        calibrated = True
    timing = {"normal_steps_per_second": info.steps_per_second()}
    if calibrated:
        # the warm-up batch compiles; the same batch again does not
        timing["compile_seconds"] = max(0.0, t_warm - t_bench)
    if not quiet and calibrated:
        print(info.timing_plan(impl_name)
              + f", ETA {info.eta_seconds(t):.1f} s")
    progress.emit("Solving CFD", f"{t}/{total_steps} steps", t, total_steps)

    avg_phase_t0 = None
    last_unsteady_t = -1
    png = _PngOutput()

    for ev in event_list:
        if ev <= resume_t:
            continue   # already handled before the interruption
        while t < ev:
            n = min(s.chunk, ev - t)
            state = runner(n)(state, case.dyn, t)
            t += n
            if not quiet and progress.enabled:
                _sync(state)
                info.update(t)
                progress.emit(
                    "Solving CFD",
                    f"{t}/{total_steps} steps | "
                    f"{info.steps_per_second():.1f} Steps/s | "
                    f"ETA {info.eta_seconds(t):.0f} s",
                    t, total_steps)
        # event actions at step t (the step keeps rho/u current)
        if avg_window and t >= avg_start and (t - avg_start) % avg_stride == 0:
            if avg_phase_t0 is None:
                _sync(state)
                avg_phase_t0 = time.perf_counter()
                avg_phase_start_t = t
            avg = welford_update(avg, state)
            avg_samples += 1
        if case.probes and t >= probe_start and (t - probe_start) % avg_stride == 0:
            # ONE batched device->host readback for all probe columns (the
            # reference batches its averaging-path readbacks the same way,
            # setup.cpp:4498-4509); per-probe gathers serialize against the
            # step stream through the device queue
            ys = np.array([p.y for p in case.probes])
            xs = np.array([p.x for p in case.probes])
            cols = np.asarray(state.u[:, :, ys, xs])     # (3, Z, P)
            for pi, p in enumerate(case.probes):
                p.sample_column(cols[:, :, pi], t * dt_si, u_factor)
        if frames and t % frames == 0 and t > 0 and png.ok():
            # per-event video frame (reference setup.cpp:4843-4861) —
            # PNG only, ffmpeg-ready numbering, perspective camera
            from .snapshots import write_frame

            frame = case.parent / "proj_temp" / "frames" / (
                f"{case.vtk_prefix}{case.datetime}_{t // frames:06d}.png")
            files.append(write_frame(
                state, frame, nz_out=case.nz_out,
                title=f"{case.vtk_prefix}{case.datetime} step {t}"))
        if unsteady and t % unsteady == 0 and t > 0 and t != last_unsteady_t:
            write_raw("u", np.asarray(state.u) * u_factor, t)
            last_unsteady_t = t
            if s.snapshots and png.ok():
                from .snapshots import write_snapshot

                snap = case.parent / "proj_temp" / "snapshots" / (
                    f"{case.vtk_prefix}{case.datetime}_{t:09d}.png")
                files.append(write_snapshot(
                    state, snap, u_factor=u_factor, nz_out=case.nz_out,
                    title=f"{case.vtk_prefix}{case.datetime} step {t}"))
        if (ckpt_path is not None and s.checkpoint_interval > 0
                and t % s.checkpoint_interval == 0 and t > resume_t):
            from .checkpoint import save_checkpoint

            save_checkpoint(ckpt_path, state, step=t, avg=avg,
                            avg_samples=avg_samples, probes=case.probes,
                            meta={"total_steps": total_steps})

    _sync(state)
    solver_seconds = time.perf_counter() - t0
    if avg_phase_t0 is not None and t > avg_phase_start_t:
        timing["avg_steps_per_second"] = (t - avg_phase_start_t) / max(
            time.perf_counter() - avg_phase_t0, 1e-9)
    timing["solver_seconds"] = solver_seconds
    timing["mlups"] = info.mlups()

    write_final_outputs(case, state, avg, avg_samples, t, files,
                        skip_raw_u=(last_unsteady_t == t))

    progress.done("Solving CFD", f"{t}/{total_steps} steps")
    return RunResult(state=state, avg=avg, total_steps=t,
                     solver_seconds=solver_seconds, files=files, timing=timing)


def write_final_outputs(case: SolverCase, state: LBMState,
                        avg: Optional[AvgState], avg_samples: int, t: int,
                        files: List[Path], *, skip_raw_u: bool = False,
                        ) -> List[Path]:
    """Finalize one case: transient u/rho[/T] VTKs, the `_avg` VTK with
    u_avg/rho_avg[/T_avg]/fluid + requested tke/TI/TLS, probe CSVs,
    transform.info (reference setup.cpp:4718-4798, 2513-2683).  Shared by
    the serial driver and the case-parallel batch runner (run/batch.py)."""
    s = case.settings
    u_factor = case.units.si_u(1.0)
    rho_factor = case.units.si_rho(1.0)
    dt_si = case.units.si_t(1)
    vtk_dir = case.parent / "RESULTS" / "vtk"
    raw_base = f"{case.vtk_prefix}{case.datetime}_raw_"

    def write_raw(name: str, data: np.ndarray, affine_T: bool = False):
        arr = np.asarray(data)
        if affine_T:
            arr = arr * case.units.unit_K + case.units.unit_K_offset
        path = vtk_dir / vtk_timestep_name(raw_base + name, t)
        write_structured_points(
            path, {"data": arr.astype(np.float32)},
            spacing=case.cell_m, origin_shift=case.origin_shift,
            nz_write=case.nz_out)
        files.append(path)

    if not skip_raw_u:
        write_raw("u", np.asarray(state.u) * u_factor)
    write_raw("rho", np.asarray(state.rho) * rho_factor)
    if case.thermal_output and state.T is not None:
        write_raw("T", np.asarray(state.T), affine_T=True)

    if avg is not None and avg_samples > 0:
        mean_u = np.asarray(avg.mean_u)
        var_sum = np.asarray(variance_sum_u(avg))
        flags = np.asarray(state.flags)
        fields: Dict[str, np.ndarray] = {
            "u_avg": (mean_u * u_factor).astype(np.float32),
            "rho_avg": (np.asarray(avg.mean_rho) * rho_factor).astype(np.float32),
        }
        if case.thermal_output and avg.mean_T is not None:
            fields["T_avg"] = (np.asarray(avg.mean_T) * case.units.unit_K
                               + case.units.unit_K_offset).astype(np.float32)
        want = tuple(f.lower() for f in s.output_fields)
        derived = derived_turbulence_fields(
            mean_u, var_sum, flags, avg_count=avg_samples,
            u_factor=u_factor, spacing=case.cell_m, want=want)
        fields["fluid"] = derived.pop("fluid")
        # tke written in SI already by derived (uses u_factor)
        for key in ("tke", "TI", "TLS"):
            if key in derived and key.lower() in want:
                fields[key] = derived[key]
        avg_path = vtk_dir / vtk_timestep_name(
            f"{case.vtk_prefix}{case.datetime}_avg", t)
        write_structured_points(avg_path, fields, spacing=case.cell_m,
                                origin_shift=case.origin_shift, nz_write=case.nz_out)
        files.append(avg_path)

    results_dir = case.parent / "RESULTS"
    for p in case.probes:
        files.append(p.write_csv(results_dir))

    if s.research_output > 0:
        info_path = case.parent / "proj_temp" / "transform.info"
        info_path.parent.mkdir(parents=True, exist_ok=True)
        info_path.write_text(f"dt = {dt_si:.10f}s\n")
        files.append(info_path)
    return files
