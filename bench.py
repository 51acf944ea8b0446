"""Step benchmark: D3Q19 MLUPs on one GPU.

Times the flagship fused step (SRT + Smagorinsky LES + equilibrium
boundaries — the reference's headline configuration, compiled without
VOLUME_FORCE, defines.hpp) at 256^3 and prints ONE JSON line naming the
device, its power limit, the tier stepped, ms/step and MLUPs.

Fails (non-zero exit, no result) when JAX finds no GPU.

Env overrides: LUW_BENCH_SHAPE="Z,Y,X", LUW_BENCH_STEPS, LUW_BENCH_REPS,
LUW_BENCH_STORAGE, LUW_BENCH_IMPL=auto|reference|pallas.

    python bench.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def gpu_name_and_power_limit() -> str:
    """`name, power.limit` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_gpu():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devices[0].platform!r} devices")
    return devices


def parse_shape() -> tuple:
    raw = os.environ.get("LUW_BENCH_SHAPE")
    if raw:
        z, y, x = (int(v) for v in raw.split(","))
        return z, y, x
    return 256, 256, 256


def bench_config(storage: str):
    from latticeurbanwind_tpu.lbm import StepConfig, omega_from_nu

    return StepConfig(omega=omega_from_nu(1e-4), collision="srt",
                      subgrid=True, storage=storage, volume_force=False)


def bench_state(shape, config):
    """Urban-run-shaped case built on the device: solid ground, equilibrium
    lateral and top boundaries, a uniform 0.05 inflow."""
    import jax
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import TYPE_E, TYPE_S, equilibrium_state

    Z, Y, X = shape

    def build():
        flags = jnp.zeros(shape, jnp.uint8)
        flags = flags.at[0].set(TYPE_S)
        flags = flags.at[-1].set(TYPE_E)
        flags = flags.at[:, 0, :].set(TYPE_E)
        flags = flags.at[:, -1, :].set(TYPE_E)
        flags = flags.at[:, :, 0].set(TYPE_E)
        flags = flags.at[:, :, -1].set(TYPE_E)
        u = jnp.zeros((3, Z, Y, X), jnp.float32).at[0].set(0.05)
        return equilibrium_state(shape, config=config, u=u, flags=flags)

    return jax.jit(build)()


def measure(storage: str, shape: tuple, steps: int, reps: int,
            impl: str) -> dict:
    """Best-of-reps ms/step of one storage on the bench configuration."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from latticeurbanwind_tpu.lbm import DynParams
    from latticeurbanwind_tpu.lbm.stepper import make_runner

    config = bench_config(storage)
    state = bench_state(shape, config)
    dyn = DynParams(force=jnp.zeros(3), omega_coriolis=jnp.zeros(3))
    run, impl_used = make_runner(config, n_inner=steps, impl=impl)

    t0 = time.perf_counter()
    state = jax.block_until_ready(run(state, dyn, 0))
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        state = jax.block_until_ready(run(state, dyn, 0))
        best = min(best, time.perf_counter() - t0)
    if not bool(jnp.isfinite(state.u).all()):
        raise SystemExit("benchmark produced non-finite velocities")
    ms = best / steps * 1e3
    return {"storage": storage, "impl": impl_used,
            "ms_per_step": ms, "mlups": float(np.prod(shape)) / ms / 1e3,
            "first_call_s": compile_s}


def main() -> int:
    from latticeurbanwind_tpu.utils.accelerator import configure_compile_cache

    devices = require_gpu()
    card = gpu_name_and_power_limit()
    configure_compile_cache()
    shape = parse_shape()
    steps = int(os.environ.get("LUW_BENCH_STEPS", "100"))
    reps = int(os.environ.get("LUW_BENCH_REPS", "3"))
    storage = os.environ.get("LUW_BENCH_STORAGE", "bf16")
    impl = os.environ.get("LUW_BENCH_IMPL", "auto")
    result = measure(storage, shape, steps, reps, impl)
    result.update({
        "shape": list(shape), "steps": steps,
        "config": "SRT+LES+EQ-BC, no volume force",
        "card": card,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
    })
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
