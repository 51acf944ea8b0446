"""Run layer: sizing, profile table, flux correction, Welford, driver e2e."""

import math
from pathlib import Path

import numpy as np
import pytest

from latticeurbanwind_tpu.bc import apply_flux_correction
from latticeurbanwind_tpu.bc.profile import (
    ProfileTable, direction_from_angle, downstream_from_direction,
    load_profile_dat, profile_boundary_fields,
)
from latticeurbanwind_tpu.lbm.state import TYPE_E, TYPE_S
from latticeurbanwind_tpu.run import bytes_per_cell, plan_grid, vtk_timestep_name
from latticeurbanwind_tpu.run.welford import (
    init_avg, variance_sum_u, welford_update,
)

EXAMPLE = (Path(__file__).resolve().parents[1] / "examples"
           / "example_ProfileResearch_noDEM")


def test_plan_grid_cell_size_mode():
    plan = plan_grid((2022.5, 1996.5, 270.0), cell_m=45.0,
                     sponge_thickness_m=200.0, sponge_enabled=True)
    assert (plan.nx, plan.ny, plan.nz_core) == (45, 44, 6)
    assert plan.sponge_extended and plan.nz == 6 + plan.sponge_cells
    assert plan.side_ref_z_cap == 5


def test_plan_grid_memory_mode_monotone():
    small = plan_grid((10000, 10000, 1000), memory_mb=1000, storage="f16")
    big = plan_grid((10000, 10000, 1000), memory_mb=8000, storage="f16")
    assert big.cell_m < small.cell_m
    assert small.bytes_per_device <= 1000 * 1024 * 1024
    assert big.bytes_per_device <= 8000 * 1024 * 1024


@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "fp16c"])
def test_bytes_per_cell_follows_the_tier(storage):
    """The kernel holds its input and output state; the jnp step adds its
    intermediates, and thermal adds the D3Q7 pair on either tier."""
    s = 4 if storage == "f32" else 2
    kernel = bytes_per_cell(storage, tier="pallas")
    assert kernel == 2 * 19 * s + 2 * 16 + 1 + 5 + 20
    assert bytes_per_cell(storage, tier="reference") > kernel
    assert (bytes_per_cell(storage, thermal=True, tier="reference")
            > bytes_per_cell(storage, tier="reference"))
    with pytest.raises(ValueError, match="tier"):
        bytes_per_cell(storage, tier="fast")


def test_plan_grid_sizes_for_the_tier(monkeypatch):
    """At one budget the jnp step gets a coarser grid than the kernel, and
    each plan stays within the budget by its own tier's model."""
    import jax

    from latticeurbanwind_tpu.run.sizing import sizing_tier

    size = (2000.0, 2000.0, 300.0)
    kern = plan_grid(size, memory_mb=4000, storage="bf16", tier="pallas")
    ref = plan_grid(size, memory_mb=4000, storage="bf16", tier="reference")
    assert ref.cell_m > kern.cell_m
    for plan in (kern, ref):
        assert plan.bytes_per_device <= 4000 * 1024 * 1024
    assert sizing_tier("auto", False, 1) == "reference"       # CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert sizing_tier("auto", False, 1) == "pallas"
    assert sizing_tier("auto", True, 1) == "reference"        # thermal
    assert sizing_tier("auto", False, 4) == "reference"       # n_gpu split
    assert sizing_tier("reference", False, 1) == "reference"


def test_profile_table_against_reference_example():
    z, u = load_profile_dat(EXAMPLE / "wind_bc" / "profile.dat")
    assert len(z) == 11 and u.max() == pytest.approx(4.0934)
    table = ProfileTable.build(z, u, table_top_si=220.0, domain_agl_si=200.0)
    # exact at sample points
    assert table.speed_at_agl(np.array([20.0]))[0] == pytest.approx(2.5361, abs=1e-3)
    assert table.speed_at_agl(np.array([200.0]))[0] == pytest.approx(4.0934, abs=1e-3)
    # clamped above the last sample, zero at/below ground
    assert table.speed_at_agl(np.array([219.0]))[0] == pytest.approx(4.0934, abs=1e-3)
    assert table.speed_at_agl(np.array([0.0]))[0] == 0.0
    assert table.speed_at_agl(np.array([-3.0]))[0] == 0.0
    # monotone-ish between samples
    mid = table.speed_at_agl(np.array([50.0]))[0]
    assert 3.0011 < mid < 3.2752


def test_profile_normalized_z_scaling():
    z = np.array([0.0, 0.5, 1.0])
    u = np.array([0.0, 5.0, 10.0])
    table = ProfileTable.build(z, u, table_top_si=200.0, domain_agl_si=200.0)
    assert table.speed_at_agl(np.array([100.0]))[0] == pytest.approx(5.0, abs=1e-2)


def test_direction_and_downstream():
    dx, dy = direction_from_angle(0.0)
    assert (round(dx, 6), round(dy, 6)) == (0.0, -1.0)
    assert downstream_from_direction(dx, dy) == "-y"
    dx, dy = direction_from_angle(270.0)
    assert downstream_from_direction(dx, dy) == "+x"


def test_profile_boundary_fields_geometry():
    shape = (10, 12, 14)
    table = ProfileTable.build(np.array([0.0, 100.0]), np.array([2.0, 10.0]),
                               table_top_si=500.0)
    flags, u = profile_boundary_fields(
        shape, table=table, cell_m=20.0, u_scale=0.01,
        ground_z_lbm=1.5, dir_x=0.0, dir_y=-1.0,
        downstream_bc="-y", side_ref_z_cap=7,
    )
    assert (flags[0] == TYPE_S).all()                   # ground plate
    assert (flags[1] == TYPE_S).all()                   # below ground (z=1.5)
    assert flags[5, 0, 7] & TYPE_E                      # south face is E
    assert flags[5, 5, 5] == 0                          # interior fluid
    # boundary speed grows with height; interior initialized with profile
    assert u[1, 3, 0, 7] < 0 and abs(u[1, 8, 0, 7]) > abs(u[1, 3, 0, 7])
    # side faces above the cap reuse the cap-height speed
    assert u[1, 9, 5, 0] == pytest.approx(u[1, 7, 5, 0])


def test_flux_correction_balances():
    shape = (8, 10, 12)
    flags = np.zeros(shape, np.uint8)
    u = np.zeros((3, *shape), np.float32)
    u[1][:] = -0.05   # uniform -y flow: in through north, out through south
    flags2, u2, report = apply_flux_correction(flags, u, downstream_bc="-y")
    assert abs(report["net_after"]) < 1e-4 * abs(report["net_before"]) + 1e-7
    # shell is now TYPE_E
    assert (flags2[:, :, 0] & TYPE_E)[1:].all()
    assert flags2[0].max() == 0                        # ground untouched
    # downstream refill hook
    flags3, u3, _ = apply_flux_correction(
        flags, u, downstream_bc="-y",
        downstream_eval=lambda m: np.full((3, *shape), 0.125, np.float32))
    assert u3[0, 4, 0, 5] != 0.0


def test_welford_matches_numpy():
    import jax.numpy as jnp
    from latticeurbanwind_tpu.lbm import LBMState

    rng = np.random.default_rng(0)
    shape = (3, 4, 5)
    samples = rng.standard_normal((7, 3, *shape)).astype(np.float32)
    avg = init_avg(shape, thermal=False)
    for i in range(7):
        state = LBMState(fi=None, rho=jnp.asarray(samples[i, 0]),
                         u=jnp.asarray(samples[i]), flags=None)
        avg = welford_update(avg, state)
    np.testing.assert_allclose(np.asarray(avg.mean_u), samples.mean(axis=0),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(variance_sum_u(avg)),
                               samples.var(axis=0).sum(axis=0),
                               rtol=2e-4, atol=1e-6)
    assert int(avg.count) == 7


def test_vtk_timestep_name():
    assert vtk_timestep_name("CaseE_avg", 20001) == "CaseE_avg-000020001.vtk"


def test_profile_mode_end_to_end(tmp_path):
    """Tiny CaseE run: deck -> STL -> solve -> VTK, via the public entry."""
    import shutil

    from latticeurbanwind_tpu.deck import load_deck
    from latticeurbanwind_tpu.io import read_structured_points
    from latticeurbanwind_tpu.run import run_deck

    src = EXAMPLE
    case = tmp_path / "caseE"
    shutil.copytree(src, case)
    deck = load_deck(case / "conf.luwpf")
    deck.set_text("mesh_control", "cell_size", quoted=True)
    deck.set_float("cell_size", 60.0)
    deck.set_int("run_nstep", 40)
    deck.set_int("purge_avg", 16)
    deck.set_int("purge_avg_stride", 4)
    deck.set_list("angle", [0.0])
    deck.save()

    results = run_deck(case / "conf.luwpf", quiet=True)
    assert len(results) == 1
    r = results[0]
    assert r.total_steps == 40
    avg_files = [f for f in r.files if "_avg-" in f.name]
    assert len(avg_files) == 1
    meta, fields = read_structured_points(avg_files[0])
    assert set(fields) >= {"u_avg", "rho_avg", "fluid", "tke", "TI", "TLS"}
    # single-angle: standard naming without ANG_ prefix
    assert avg_files[0].name.startswith("20260101120000_avg-")
    u = fields["u_avg"]
    fluid = fields["fluid"] > 0.5
    assert u[1][fluid].mean() < -1.0   # angle 0 -> -y flow in SI m/s
    assert np.isfinite(u).all()


def test_profile_mode_multichip_matches_single(tmp_path):
    """n_gpu=[1,1,2] shards the case over a 2-device GSPMD mesh; results
    must match the single-device run (driver.py device-mesh wiring)."""
    import shutil

    from latticeurbanwind_tpu.deck import load_deck
    from latticeurbanwind_tpu.io import read_structured_points
    from latticeurbanwind_tpu.run import run_deck

    src = EXAMPLE
    outs = {}
    for tag, ngpu in (("single", [1, 1, 1]), ("sharded", [1, 1, 2])):
        case = tmp_path / tag
        shutil.copytree(src, case)
        deck = load_deck(case / "conf.luwpf")
        deck.set_text("mesh_control", "cell_size", quoted=True)
        deck.set_float("cell_size", 60.0)
        deck.set_int("run_nstep", 24)
        deck.set_int("purge_avg", 8)
        deck.set_int("purge_avg_stride", 4)
        deck.set_list("angle", [0.0])
        deck.set_list("n_gpu", ngpu)
        deck.save()
        r = run_deck(case / "conf.luwpf", quiet=True)[0]
        avg = [f for f in r.files if "_avg-" in f.name][0]
        outs[tag] = read_structured_points(avg)[1]

    # GSPMD changes XLA fusion order for the dense VK slab updates, which
    # shifts individual f32 roundings; LES amplifies those over the run.
    # 2e-4 m/s on ~5 m/s flows = physically identical.
    for name in ("u_avg", "rho_avg", "tke"):
        np.testing.assert_allclose(outs["sharded"][name], outs["single"][name],
                                   atol=2e-4, err_msg=name)
