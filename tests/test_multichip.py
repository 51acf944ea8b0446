"""Multi-chip sharding correctness: sharded step == single-device step.

Runs on the virtual 8-device CPU mesh (conftest).  This is the test the
reference never had: bitwise comparison of the domain-decomposed update
against the single-domain ground truth (SURVEY.md §4 implication).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from latticeurbanwind_tpu.lbm import (
    DynParams, NudgeSpec, SpongeSpec, StepConfig, TYPE_E, TYPE_S,
    build_forcing, make_initial_state, make_step, omega_from_nu,
)
from latticeurbanwind_tpu.parallel import domain_mesh, shard_state, state_sharding


def _case(shape, thermal=False):
    config = StepConfig(omega=omega_from_nu(0.03), subgrid=True, thermal=thermal,
                        omega_t=1.0, storage="f32")
    rng = np.random.default_rng(7)
    Z, Y, X = shape
    u = 0.02 * rng.standard_normal((3, Z, Y, X)).astype(np.float32)
    rho = (1.0 + 0.001 * rng.standard_normal(shape)).astype(np.float32)
    flags = np.zeros(shape, dtype=np.uint8)
    flags[0] = TYPE_S
    flags[-1] = TYPE_E
    flags[:, 0, :] |= TYPE_E
    flags[:, -1, :] |= TYPE_E
    flags[:, :, 0] |= TYPE_E
    flags[:, :, -1] |= TYPE_E
    T = (1.0 + 0.01 * rng.standard_normal(shape)).astype(np.float32) if thermal else None
    state = make_initial_state(shape, config=config, rho=rho, u=u, flags=flags, T=T)
    forcing = build_forcing(shape,
                            nudge=NudgeSpec(n_cells=3, inv_tau=0.02),
                            sponge=SpongeSpec(n_cells=4, inv_tau=0.05))
    return config, state, forcing


@pytest.mark.parametrize("split", [(2, 1, 1), (2, 2, 1), (2, 2, 2)])
def test_sharded_step_matches_single(split):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    shape = (8, 8, 16)
    config, state, forcing = _case(shape)
    step = make_step(config, forcing)
    dyn = DynParams(force=jnp.array([1e-6, 0.0, 0.0]),
                    omega_coriolis=jnp.array([0.0, 1e-5, 2e-5]))

    # ground truth on one device
    ref = state
    step_j = jax.jit(step)
    for _ in range(5):
        ref = step_j(ref, dyn)

    mesh = domain_mesh(split)
    sharded = shard_state(state, mesh)
    shardings = state_sharding(mesh, thermal=False)
    step_sharded = jax.jit(step, out_shardings=shardings)
    out = sharded
    for _ in range(5):
        out = step_sharded(out, dyn)

    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.rho), np.asarray(ref.rho), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.fi), np.asarray(ref.fi), atol=1e-6)


def test_sharded_thermal_step_matches_single():
    shape = (8, 8, 16)
    config, state, forcing = _case(shape, thermal=True)
    step = make_step(config, forcing)
    dyn = DynParams(force=jnp.zeros(3), omega_coriolis=jnp.zeros(3))

    ref = jax.jit(step)(state, dyn)
    mesh = domain_mesh((2, 2, 2))
    sharded = shard_state(state, mesh)
    out = jax.jit(step, out_shardings=state_sharding(mesh, thermal=True))(sharded, dyn)
    np.testing.assert_allclose(np.asarray(out.T), np.asarray(ref.T), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-6)


@pytest.mark.parametrize("ngpu", [(1, 1, 4), (2, 2, 1), (2, 1, 2)])
def test_run_case_split_matches_single(tmp_path, ngpu):
    """The driver's n_gpu path (GSPMD over the jnp step, with averaging
    events) reproduces the single-device run of the same case."""
    from latticeurbanwind_tpu.run.driver import RunSettings, SolverCase, run_case
    from latticeurbanwind_tpu.units import Units

    def run(split, sub):
        config, state, forcing = _case((8, 8, 16))
        units = Units()
        units.set_m_kg_s(1.0, 0.1, 1.0, 20.0, 8.0, 1.225)
        (tmp_path / sub).mkdir()
        case = SolverCase(
            config=config, forcing=forcing, state=state,
            dyn=DynParams(force=jnp.zeros(3),
                          omega_coriolis=jnp.array([0.0, 1e-5, 2e-5])),
            units=units, cell_m=20.0, parent=tmp_path / sub, datetime="0",
            ngpu=split,
            settings=RunSettings(run_nstep=12, purge_avg=6,
                                 purge_avg_stride=2, chunk=4,
                                 snapshots=False))
        r = run_case(case, quiet=True)
        return r.state, r.avg

    s1, a1 = run((1, 1, 1), "single")
    sn, an = run(ngpu, "split")
    assert len(sn.fi.sharding.device_set) == int(np.prod(ngpu))
    np.testing.assert_allclose(np.asarray(sn.u), np.asarray(s1.u),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(an.mean_u), np.asarray(a1.mean_u),
                               atol=1e-6, rtol=0)
