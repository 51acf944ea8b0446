#!/usr/bin/env python3
"""Smoke run of the solver's main path on one NVIDIA GPU.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the multi-card paths, on four cards

One card, in order:
  1. the `gpu`-marked tests (tests/test_stream_collide_gpu.py);
  2. the profile-research example deck through `run_deck`, sized by memory
     (gpu_memory = 20000 MiB, the deck default), a few hundred steps with
     its VK inlet, sponge and averaging window; it runs before the large
     kernel checks so that the process's peak memory is the deck's;
  3. the fused stream-collide kernel, compiled for the card, against the jnp
     step (lbm/reference.py) at 256^3 and at 96x250x333 (one step and 100
     steps) in every storage, and at 128x1024x1024 in bf16;
  4. the NWP-coupled `.luw` example at its own size: makeluw, then runluw.

With --four-cards only the paths that span cards run: the profile deck
split with n_gpu = [1,1,4] and [2,2,1] against [1,1,1], and the dataset
example swept case-parallel over four cards against its serial run.

Every phase checks its own result; any failure ends the script with a
non-zero exit.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Work files go to .smoke_work/ in the checkout and are removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke_work"
EXAMPLES = ROOT / "examples"
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


# --------------------------------------------------------------------------
# phase 1: the gpu-marked tests


def phase_gpu_tests() -> None:
    import pytest

    os.environ["LUW_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", str(ROOT),
                      str(ROOT / "tests" / "test_stream_collide_gpu.py")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


# --------------------------------------------------------------------------
# phase 3: kernel against the jnp step


def random_case(shape, storage, production: bool, seed: int = 0):
    """A city-like state built on the device: solid ground and random
    blocks, equilibrium inflow/outflow faces and top, random velocities.
    `production`: the deck physics (LES, Guo forcing with Coriolis, nudge
    bands, top sponge, ground and side wall models); else the benchmark
    configuration (LES, equilibrium boundaries, no volume force)."""
    import jax
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import (
        DynParams, Forcing, StepConfig, TYPE_E, TYPE_S, equilibrium_state,
        omega_from_nu,
    )

    Z, Y, X = shape
    if production:
        cfg = StepConfig(omega=1.9, collision="srt", storage=storage,
                         wall_model=True, wall_cd=0.0134, wall_sides=True,
                         wall_cd_sides=0.004)
    else:
        cfg = StepConfig(omega=omega_from_nu(1e-4), storage=storage,
                         volume_force=False)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)

    def build():
        zz = jnp.arange(Z)[:, None, None]
        block = jax.random.uniform(k1, (Y, X)) < 0.08
        height = (jax.random.uniform(k2, (Y, X)) * Z * 0.3).astype(jnp.int32)
        flags = jnp.where(block[None] & (zz < height[None]), TYPE_S, 0)
        flags = flags.astype(jnp.uint8).at[0].set(TYPE_S).at[-1].set(TYPE_E)
        flags = flags.at[:, :, 0].set(TYPE_E).at[:, :, -1].set(TYPE_E)
        u = (0.03 * jax.random.normal(k3, (3, *shape))
             + jnp.array([0.05, 0.01, 0.0])[:, None, None, None])
        return equilibrium_state(shape, config=cfg, u=u, flags=flags)

    state = jax.jit(build)()
    forcing = Forcing()
    dyn = DynParams(force=jnp.zeros(3), omega_coriolis=jnp.zeros(3))
    if production:
        xx = jnp.arange(X)[None, None, :]
        nsig = (jnp.where(xx < 6, 0.05, jnp.where(xx >= X - 6, 0.02, 0.0))
                * jnp.ones(shape)).astype(jnp.float32)
        nface = (jnp.where(xx >= X - 6, 1, 0) * jnp.ones(shape)).astype(jnp.int8)
        spz = jnp.where(jnp.arange(Z) >= Z - 8, 0.2, 0.0).astype(jnp.float32)
        forcing = Forcing(nudge_sigma=nsig, nudge_face=nface,
                          sponge_sigma_z=spz)
        dyn = DynParams(force=jnp.array([2e-6, 0.0, 0.0], jnp.float32),
                        omega_coriolis=jnp.array([0.0, 6e-6, 8e-6], jnp.float32))
    return cfg, forcing, state, dyn


# max |du| (lattice units) after 100 steps of the deck physics at 96x250x333,
# kernel against the jnp step from the same state.  Single-rounding
# differences (FMA contraction) grow under LES.  On an H100 the readings were
# 2.3e-7 (f32), 2.5e-4 (bf16), 7.0e-5 (f16) and 3.4e-5 (fp16c); a step that
# keeps its decoded DDFs in 16 bits drifts by 1.2e-2 (bf16) and 1.2e-3 (f16,
# fp16c), so each bound sits between the two.
DRIFT_BOUND = {"f32": 1e-5, "bf16": 1e-3, "f16": 2e-4, "fp16c": 2e-4}


def ddf_stats(a, b, storage: str):
    """Compare two DDF arrays on the device, one direction at a time (the
    19 x cells arrays of a large grid stay off the host).  Returns max |df|,
    the count of DDFs within one storage ulp (16-bit storages), and the
    count neither within one ulp nor within 1e-6 absolute."""
    import jax
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import decode_ddf

    def ordered(x):
        i = jax.lax.bitcast_convert_type(x, jnp.uint16).astype(jnp.int32)
        return jnp.where(i & 0x8000, -(i & 0x7FFF), i & 0x7FFF)

    @jax.jit
    def one(a, b, q):
        x = jax.lax.dynamic_index_in_dim(a, q, keepdims=False)
        y = jax.lax.dynamic_index_in_dim(b, q, keepdims=False)
        d = jnp.abs(decode_ddf(x, storage) - decode_ddf(y, storage))
        if storage == "f32":
            near = jnp.zeros(d.shape, bool)
        else:
            near = jnp.abs(ordered(x) - ordered(y)) <= 1
        return d.max(), near.sum(), (~near & (d > 1e-6)).sum()

    max_df, within, bad = 0.0, 0, 0
    for q in range(int(a.shape[0])):
        m, w, n = one(a, b, q)
        max_df, within, bad = max(max_df, float(m)), within + int(w), bad + int(n)
    return max_df, within, bad


def compare(shape, storage: str, production: bool, steps: int = 1) -> dict:
    """One step of the kernel against the jnp step from the same state.
    Bounds: f32 storage max|df| <= 1e-6; 16-bit storage >= 99.99 % of DDFs
    within one storage ulp and every DDF within one ulp or 1e-6 absolute
    (near zero one f32 rounding spans many 16-bit ulps); rho and u within
    1e-6.  With steps > 1 both tiers go on stepping and max |du| after
    `steps` must stay within DRIFT_BOUND."""
    import jax
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import make_step
    from latticeurbanwind_tpu.ops.stream_collide import make_pallas_step

    cfg, forcing, state, dyn = random_case(shape, storage, production)
    kstep = jax.jit(make_pallas_step(cfg, forcing))
    rstep = jax.jit(make_step(cfg, forcing))
    ref = jax.block_until_ready(rstep(state, dyn))
    t0 = time.perf_counter()
    out = jax.block_until_ready(kstep(state, dyn))
    first_s = time.perf_counter() - t0
    del state
    max_df, within, bad = ddf_stats(out.fi, ref.fi, storage)

    def max_diff(a, b):
        return float(jnp.abs(a - b).max())

    res = {"shape": list(shape), "storage": storage,
           "config": "production" if production else "bench",
           "kernel_first_call_s": round(first_s, 1),
           "max_abs_df": max_df,
           "max_abs_drho": max_diff(out.rho, ref.rho),
           "max_abs_du": max_diff(out.u, ref.u)}
    if storage == "f32":
        ok = max_df <= 1e-6
    else:
        res["share_within_1ulp"] = within / out.fi.size
        ok = res["share_within_1ulp"] >= 0.9999 and bad == 0
    ok = ok and max(res["max_abs_drho"], res["max_abs_du"]) <= 1e-6
    if steps > 1:
        for _ in range(steps - 1):
            out, ref = kstep(out, dyn), rstep(ref, dyn)
        res["steps"] = steps
        res["max_abs_du_after_steps"] = max_diff(out.u, ref.u)
        res["drift_bound"] = DRIFT_BOUND[storage]
        ok = (ok and bool(jnp.isfinite(out.u).all())
              and res["max_abs_du_after_steps"] <= DRIFT_BOUND[storage])
    res["ok"] = bool(ok)
    log("kernel-vs-jnp " + json.dumps(res))
    check(ok, f"kernel disagrees with the jnp step: {res}")
    return res


def phase_kernel() -> None:
    """At 256^3 (the bench configuration) and 96x250x333 (the deck physics,
    masked block tails, 100 steps) in every storage; then one step at
    128x1024x1024 in bf16, where the DDF array holds 2.55e9 values and its
    offsets pass 2^31."""
    for storage in ("f32", "bf16", "f16", "fp16c"):
        compare((256, 256, 256), storage, production=False)
        compare((96, 250, 333), storage, production=True, steps=100)
    compare((128, 1024, 1024), "bf16", production=True)


# --------------------------------------------------------------------------
# phase 2/4: decks through the user entry points


def stage(example: str, name: str) -> Path:
    dst = WORK / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(EXAMPLES / example, dst,
                    ignore=shutil.ignore_patterns("RESULTS", "*.log"))
    return dst


def read_avg(files, expect_fields=("u_avg", "rho_avg", "fluid", "tke")):
    """Parse every averaged VTK of a run; all fields finite."""
    import numpy as np

    from latticeurbanwind_tpu.io import read_structured_points

    avg = [f for f in files if "_avg-" in Path(f).name]
    check(len(avg) >= 1, "no averaged VTK written")
    out = {}
    for f in avg:
        meta, fields = read_structured_points(f)
        check(set(expect_fields) <= set(fields),
              f"{Path(f).name}: fields {sorted(fields)}")
        for k, v in fields.items():
            check(bool(np.isfinite(np.asarray(v, np.float64)).all()),
                  f"{Path(f).name}: non-finite {k}")
        out[Path(f).name] = fields
    return out


def profile_deck(name: str, **keys) -> Path:
    """The profile-research example, prepared with dgprepare, with deck
    keys overridden (lists and numbers as given, strings quoted)."""
    from latticeurbanwind_tpu.deck import load_deck
    from latticeurbanwind_tpu.pre.dgprepare import main as dgprepare

    case = stage("example_ProfileResearch_noDEM", name)
    check(dgprepare([str(case / "conf.luwpf")]) == 0, "dgprepare failed")
    deck = load_deck(case / "conf.luwpf")
    for k, v in keys.items():
        if isinstance(v, list):
            deck.set_list(k, v)
        elif isinstance(v, str):
            deck.set_text(k, v, quoted=True)
        elif isinstance(v, float):
            deck.set_float(k, v)
        else:
            deck.set_int(k, v)
    deck.save()
    return case / "conf.luwpf"


def run_deck_timed(deck_path: Path, **kw):
    import jax

    from latticeurbanwind_tpu.run import run_deck

    t0 = time.perf_counter()
    results = run_deck(deck_path, **kw)
    wall = time.perf_counter() - t0
    jax.block_until_ready(results[-1].state.u)
    return results, wall


def phase_profile_deck() -> None:
    """The main path at the deck's own memory-sized grid.  The device's peak
    must stay within the budget the grid was sized for (2 % slack)."""
    import jax
    import numpy as np

    deck = profile_deck("profile", mesh_control="gpu_memory",
                        gpu_memory=20000, run_nstep=300, purge_avg=100,
                        purge_avg_stride=2, unsteady_output=0, angle=[0.0])
    dev = jax.devices()[0]
    results, wall = run_deck_timed(deck)
    r = results[0]
    shape = tuple(r.state.rho.shape)
    cells = int(np.prod(shape))
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    t = r.timing
    res = {"deck": "example_ProfileResearch_noDEM (gpu_memory=20000)",
           "grid_zyx": list(shape), "cells": cells,
           "steps": r.total_steps,
           "setup_s": wall - r.solver_seconds,
           "compile_s": t.get("compile_seconds"),
           "stepping_s": r.solver_seconds - (t.get("compile_seconds") or 0.0),
           "mlups": t.get("mlups"),
           "ms_per_step": 1e3 / t["normal_steps_per_second"],
           "peak_bytes_in_use": peak,
           "peak_bytes_per_cell": (peak / cells) if peak else None}
    log("profile-deck " + json.dumps(res))
    read_avg(r.files)
    check(r.total_steps == 300, "deck did not run its steps")
    budget = 20000 * 1024 * 1024
    check(peak is not None and peak <= 1.02 * budget,
          f"device peak {peak} B over the {budget} B budget")
    results.clear()
    r = None


def phase_nwp() -> None:
    """The NWP-coupled flagship mode at the example's own size."""
    from latticeurbanwind_tpu.cli.makeluw import main as makeluw
    from latticeurbanwind_tpu.cli.run import main as runluw

    case = stage("example_NWP-LBM", "nwp")
    deck = case / "conf.luw"
    check(makeluw([str(deck)]) == 0, "makeluw failed")
    t0 = time.perf_counter()
    check(runluw([str(deck)]) == 0, "runluw failed")
    wall = time.perf_counter() - t0
    files = sorted((case / "RESULTS" / "vtk").glob("*_avg-*.vtk"))
    read_avg(files)
    log("nwp-deck " + json.dumps({"deck": "example_NWP-LBM", "wall_s": wall,
                                  "avg_vtks": [f.name for f in files]}))


# --------------------------------------------------------------------------
# four cards


def max_field_diff(a: dict, b: dict, names) -> dict:
    import numpy as np

    out = {}
    for fname in a:
        for n in names:
            out[f"{fname}:{n}"] = float(np.abs(
                np.asarray(a[fname][n], np.float64)
                - np.asarray(b[fname][n], np.float64)).max())
    return out


def phase_splits() -> None:
    """n_gpu splits (GSPMD over the jnp step) against the same step on one
    card, at a grid one card holds.  f32 storage keeps the comparison at
    f32 rounding; the bound, 1e-3 m/s on ~4 m/s flow after 40 LES steps,
    is a few hundred f32 ulps of growth from reordered sums.  At 2 m cells
    the grid (88, 318, 318) divides evenly under both splits."""
    common = dict(mesh_control="cell_size", cell_size=2.0, run_nstep=40,
                  purge_avg=16, purge_avg_stride=2, unsteady_output=0,
                  angle=[0.0], lbm_storage="f32")
    avg = {}
    for tag, ngpu, impl in (("single_jnp", [1, 1, 1], "reference"),
                            ("z4", [1, 1, 4], "auto"),
                            ("xy22", [2, 2, 1], "auto")):
        deck = profile_deck(f"split_{tag}", n_gpu=ngpu, **common)
        results, wall = run_deck_timed(deck, impl=impl)
        r = results[0]
        avg[tag] = read_avg(r.files)
        devices = len(r.state.fi.sharding.device_set)
        log("split-run " + json.dumps({
            "run": tag, "n_gpu": ngpu, "grid_zyx": list(r.state.rho.shape),
            "devices": devices,
            "ms_per_step": 1e3 / r.timing["normal_steps_per_second"],
            "wall_s": wall}))
        check(devices == ngpu[0] * ngpu[1] * ngpu[2],
              f"{tag}: stepped on {devices} device(s), n_gpu = {ngpu}")
        results.clear()
    names = ("u_avg", "rho_avg", "tke")
    for tag in ("z4", "xy22"):
        d = max_field_diff(avg[tag], avg["single_jnp"], names)
        worst = max(d.values())
        log("split-compare " + json.dumps({"run": tag, "vs": "single_jnp",
                                           "max_abs_diff": d, "bound": 1e-3}))
        check(worst <= 1e-3, f"{tag} differs from the one-card run: {d}")


def phase_case_parallel() -> None:
    """The dataset example (2 inflows x 2 angles) swept case-parallel, one
    case per card, against its serial run on one card: the same step on
    the same data, so after 30 steps in f32 storage the bound is f32
    rounding in a reordered program: |a - b| <= 2e-5 + 2e-4 |b|, as
    tests/test_case_parallel.py pins."""
    import numpy as np

    from latticeurbanwind_tpu.deck import load_deck

    avg = {}
    for tag, par in (("serial", False), ("parallel", True)):
        case = stage("example_DatasetGen", f"dg_{tag}")
        deck = load_deck(case / "conf.luwdg")
        deck.set_int("run_nstep", 30)
        deck.set_int("purge_avg", 12)
        deck.set_int("purge_avg_stride", 3)
        deck.set_text("lbm_storage", "f32", quoted=True)
        deck.set_bool("case_parallel", par)
        deck.save()
        results, wall = run_deck_timed(case / "conf.luwdg")
        check(all(("case_parallel_batch" in r.timing) == par for r in results),
              f"{tag}: wrong batch path")
        files = [f for r in results for f in r.files]
        avg[tag] = read_avg(files)
        log("dataset-run " + json.dumps({
            "run": tag, "cases": len(results),
            "grid_zyx": list(results[-1].state.rho.shape), "wall_s": wall}))
        results.clear()
    check(len(avg["serial"]) == 4 and set(avg["serial"]) == set(avg["parallel"]),
          "case sets differ")
    worst = 0.0
    for fname in avg["serial"]:
        for n in ("u_avg", "rho_avg", "tke"):
            a = np.asarray(avg["parallel"][fname][n], np.float64)
            b = np.asarray(avg["serial"][fname][n], np.float64)
            worst = max(worst, float((np.abs(a - b)
                                      / (2e-5 + 2e-4 * np.abs(b))).max()))
    log("dataset-compare " + json.dumps({
        "max_diff_over_bound": worst, "bound": "2e-5 + 2e-4*|serial|"}))
    check(worst <= 1.0, f"case-parallel differs from serial ({worst}x bound)")


# --------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths (needs 4 GPUs)")
    args = ap.parse_args()

    log(card_line())
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    if args.four_cards and len(devices) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    from latticeurbanwind_tpu.utils.accelerator import configure_compile_cache

    configure_compile_cache()
    log(f"device: {devices[0].device_kind} x{len(devices)}")

    if args.four_cards:
        phases = [phase_splits, phase_case_parallel]
    else:
        phases = [phase_gpu_tests, phase_profile_deck, phase_kernel,
                  phase_nwp]
    WORK.mkdir(exist_ok=True)
    try:
        for phase in phases:
            t0 = time.perf_counter()
            log(f"== {phase.__name__}")
            phase()
            log(f"== {phase.__name__} done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
