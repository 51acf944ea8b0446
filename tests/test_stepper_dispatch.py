"""Step-tier dispatch (lbm/stepper.py), the runner contract, the traffic
model of the tier stepped, and the compile-cache placement."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from latticeurbanwind_tpu.lbm import (
    DynParams, Forcing, NudgeSpec, SpongeSpec, StepConfig, TYPE_E, TYPE_S,
    build_forcing, make_initial_state, make_multi_step,
)
from latticeurbanwind_tpu.lbm.stepper import (
    kernel_available, make_runner, select_impl,
)

REPO = Path(__file__).resolve().parents[1]
THERMAL = StepConfig(omega=1.5, thermal=True, omega_t=1.2)
PLAIN = StepConfig(omega=1.5)


def _dyn():
    return DynParams(force=jnp.zeros(3), omega_coriolis=jnp.zeros(3))


def test_auto_steps_jnp_on_cpu():
    assert not kernel_available(PLAIN)
    assert select_impl(PLAIN, "auto") == "reference"
    assert select_impl(PLAIN, "reference") == "reference"


def test_pallas_raises_off_gpu():
    with pytest.raises(ValueError, match="GPU"):
        select_impl(PLAIN, "pallas")
    with pytest.raises(ValueError, match="GPU"):
        make_runner(PLAIN, impl="pallas")


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown impl"):
        select_impl(PLAIN, "fast")


def test_auto_takes_kernel_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert select_impl(PLAIN, "auto") == "pallas"
    assert select_impl(PLAIN, "pallas") == "pallas"


def test_thermal_steps_jnp_even_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert select_impl(THERMAL, "auto") == "reference"
    with pytest.raises(ValueError, match="thermal"):
        select_impl(THERMAL, "pallas")


def _forced_case():
    shape = (8, 8, 16)
    cfg = StepConfig(omega=1.6, storage="f32")
    flags = np.zeros(shape, np.uint8)
    flags[0] = TYPE_S
    flags[-1] = TYPE_E
    u = np.zeros((3, *shape), np.float32)
    u[0] = 0.04
    forcing = build_forcing(shape, nudge=NudgeSpec(n_cells=2, inv_tau=0.05),
                            sponge=SpongeSpec(n_cells=3, inv_tau=0.05))
    state = make_initial_state(shape, config=cfg, u=u, flags=flags)
    return cfg, forcing, state


def test_runner_matches_multi_step_with_traced_forcing():
    """The runner passes the forcing fields as traced arguments; the result
    equals the closure-constant multi-step, for any traced trip count."""
    cfg, forcing, state = _forced_case()
    want = make_multi_step(cfg, forcing, n_inner=7)(state, _dyn())
    run, impl = make_runner(cfg, forcing, n_inner=3, donate=False)
    assert impl == "reference"
    mid = run(state, _dyn(), 0)              # n_inner steps
    got = run(mid, _dyn(), 3, 4)             # then a traced count of 4
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(np.asarray(got.fi), np.asarray(want.fi),
                               atol=1e-7, rtol=0)


def test_runner_pre_step_sees_global_step_index():
    cfg, forcing, state = _forced_case()
    seen = []

    def hook(st, t):
        jax.debug.callback(lambda v: seen.append(int(v)), t)
        return st

    run, _ = make_runner(cfg, Forcing(), n_inner=1, donate=False,
                         pre_step=hook)
    jax.block_until_ready(run(state, _dyn(), 5, 3))
    jax.effects_barrier()
    assert seen == [5, 6, 7]


def test_runner_memory_analysis():
    cfg, forcing, state = _forced_case()
    run, _ = make_runner(cfg, forcing, n_inner=2, donate=False)
    mem = run.memory_analysis(state, _dyn(), 0)
    assert mem.temp_size_in_bytes >= 0
    assert mem.argument_size_in_bytes > 0


def test_driver_prints_the_step_tier(tmp_path, capsys):
    from latticeurbanwind_tpu.run.driver import RunSettings, SolverCase, run_case
    from latticeurbanwind_tpu.units import Units

    cfg, forcing, state = _forced_case()
    units = Units()
    units.set_m_kg_s(1.0, 0.1, 1.0, 20.0, 8.0, 1.225)
    case = SolverCase(config=cfg, forcing=forcing, state=state, dyn=_dyn(),
                      units=units, cell_m=20.0, parent=tmp_path,
                      datetime="20250101000000",
                      settings=RunSettings(run_nstep=4, snapshots=False))
    run_case(case)
    assert "| Step tier       | reference" in capsys.readouterr().out


def test_driver_refuses_pallas_with_a_split(tmp_path):
    from latticeurbanwind_tpu.run.driver import RunSettings, SolverCase, run_case
    from latticeurbanwind_tpu.units import Units

    cfg, forcing, state = _forced_case()
    case = SolverCase(config=cfg, forcing=forcing, state=state, dyn=_dyn(),
                      units=Units(), cell_m=20.0, parent=tmp_path,
                      datetime="0", impl="pallas", ngpu=(1, 1, 2),
                      settings=RunSettings(run_nstep=2, snapshots=False))
    with pytest.raises(ValueError, match="one device"):
        run_case(case, quiet=True)


@pytest.mark.parametrize("storage,thermal,impl,want", [
    ("bf16", False, "pallas", 19 * 2 * 2 + 1 + 16),
    ("bf16", False, "reference", 19 * 2 * 2 + 1 + 32),
    ("f32", False, "pallas", 19 * 4 * 2 + 1 + 16),
    ("f16", True, "reference", 19 * 2 * 2 + 1 + 32 + 7 * 2 * 2 + 8),
])
def test_bandwidth_model_follows_the_tier(storage, thermal, impl, want):
    from latticeurbanwind_tpu.run.info import RunInfo, bytes_per_cell_update

    assert bytes_per_cell_update(storage, thermal, impl) == want
    info = RunInfo(total_steps=10, n_cells=1_000_000, storage=storage,
                   thermal=thermal, impl=impl)
    info.normal_s_per_step = 1e-3          # 1000 MLUPs
    assert info.bandwidth_gbps() == pytest.approx(want)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from latticeurbanwind_tpu.utils import accelerator

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert Path(accelerator.compile_cache_dir()) == REPO / ".jax_cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert accelerator.compile_cache_dir() == "/some/where"


def test_compile_cache_lands_where_the_variable_says(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs are cached
    there, and that is the only cache directory JAX is given."""
    cache = tmp_path / "cache"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from latticeurbanwind_tpu.utils.accelerator import configure_compile_cache\n"
        "print(configure_compile_cache())\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(4)).block_until_ready()\n"
        "print(jax.config.jax_compilation_cache_dir)\n")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines() == [str(cache), str(cache)]
    assert any(cache.iterdir())
