"""Analytic physics validation for the reference-tier LBM step.

The reference repo has no solver tests (SURVEY.md §4); these establish the
ground truth the GPU kernel and multi-device path are later checked against.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from latticeurbanwind_tpu.lbm import (
    DynParams, LBMState, NudgeSpec, SpongeSpec, StepConfig,
    TYPE_E, TYPE_S, TYPE_T,
    build_forcing, check_lattice_integrity, make_initial_state, make_multi_step,
    make_step, omega_from_nu, omega_t_from_alpha,
)
from latticeurbanwind_tpu.lbm.forcing import build_nudge_fields, build_sponge_profile


def dyn_zero():
    return DynParams(force=jnp.zeros(3), omega_coriolis=jnp.zeros(3))


def test_lattice_integrity():
    check_lattice_integrity()


def _random_smooth_state(shape, config, seed=0, amp=0.02):
    rng = np.random.default_rng(seed)
    Z, Y, X = shape
    u = np.zeros((3, Z, Y, X), dtype=np.float32)
    for a in range(3):
        kz, ky, kx = rng.integers(1, 3, size=3)
        ph = rng.uniform(0, 2 * np.pi, size=3)
        z, y, x = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X), indexing="ij")
        u[a] = amp * np.sin(2 * np.pi * kx * x / X + ph[0]) * \
            np.cos(2 * np.pi * ky * y / Y + ph[1]) * np.cos(2 * np.pi * kz * z / Z + ph[2])
    rho = 1.0 + amp * 0.1 * rng.standard_normal(shape).astype(np.float32)
    return make_initial_state(shape, config=config, rho=rho, u=u)


@pytest.mark.parametrize("collision", ["srt", "trt"])
def test_mass_momentum_conservation_periodic(collision):
    shape = (8, 8, 16)
    config = StepConfig(omega=omega_from_nu(0.05), collision=collision,
                        subgrid=False, storage="f32")
    state = _random_smooth_state(shape, config)
    run = make_multi_step(config, n_inner=50)
    mass0 = float(jnp.sum(state.rho))
    out = run(state, dyn_zero())
    mass1 = float(jnp.sum(out.rho))
    assert abs(mass1 - mass0) / mass0 < 1e-5
    # momentum: sum(rho*u) conserved without forces/boundaries
    mom0 = np.asarray(jnp.sum(state.rho * state.u, axis=(1, 2, 3)))
    mom1 = np.asarray(jnp.sum(out.rho * out.u, axis=(1, 2, 3)))
    assert np.allclose(mom0, mom1, atol=1e-4)


def test_taylor_green_decay():
    """2-D Taylor-Green vortex in a periodic box decays as exp(-2 nu k^2 t)."""
    N = 32
    nu = 0.02
    shape = (4, N, N)
    config = StepConfig(omega=omega_from_nu(nu), subgrid=False, storage="f32")
    k = 2 * np.pi / N
    z, y, x = np.meshgrid(np.arange(4), np.arange(N), np.arange(N), indexing="ij")
    U0 = 0.01
    u = np.zeros((3, *shape), dtype=np.float32)
    u[0] = U0 * np.sin(k * x) * np.cos(k * y)
    u[1] = -U0 * np.cos(k * x) * np.sin(k * y)
    rho = 1.0 - (3.0 * U0**2 / 4.0) * (np.cos(2 * k * x) + np.cos(2 * k * y))
    state = make_initial_state(shape, config=config, rho=rho, u=u)
    steps = 200
    run = make_multi_step(config, n_inner=steps)
    out = run(state, dyn_zero())
    expected = U0 * np.exp(-2.0 * nu * k * k * steps)
    measured = float(jnp.max(jnp.abs(out.u[0])))
    assert abs(measured - expected) / expected < 0.02, (measured, expected)


def test_poiseuille_profile():
    """Body-force channel flow between halfway bounce-back walls."""
    Nz = 18
    shape = (Nz, 4, 8)
    nu = 0.1
    config = StepConfig(omega=omega_from_nu(nu), subgrid=False, storage="f32")
    flags = np.zeros(shape, dtype=np.uint8)
    flags[0] = TYPE_S
    flags[-1] = TYPE_S
    state = make_initial_state(shape, config=config, flags=flags)
    f = 1e-5
    dyn = DynParams(force=jnp.array([f, 0.0, 0.0]), omega_coriolis=jnp.zeros(3))
    run = make_multi_step(config, n_inner=500)
    for _ in range(12):
        state = run(state, dyn)
    ux = np.asarray(state.u[0, :, 2, 4])
    # walls at z=0.5 and z=Nz-1.5; H = Nz-2 cells; u(z) = f/(2 nu) * d*(H-d)
    zc = np.arange(Nz, dtype=np.float64)
    d = zc - 0.5
    H = Nz - 2.0
    expected = f / (2.0 * nu) * d * (H - d)
    interior = slice(1, Nz - 1)
    err = np.abs(ux[interior] - expected[interior]) / expected[interior].max()
    assert err.max() < 0.02, err.max()


def test_equilibrium_boundary_holds_uniform_flow():
    shape = (8, 8, 8)
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=True, storage="f32")
    u0 = np.zeros((3, *shape), dtype=np.float32)
    u0[0] = 0.05
    flags = np.zeros(shape, dtype=np.uint8)
    for axis_slice in [(0, slice(None), slice(None)), (-1, slice(None), slice(None)),
                       (slice(None), 0, slice(None)), (slice(None), -1, slice(None)),
                       (slice(None), slice(None), 0), (slice(None), slice(None), -1)]:
        flags[axis_slice] |= TYPE_E
    state = make_initial_state(shape, config=config, u=u0, flags=flags)
    run = make_multi_step(config, n_inner=100)
    out = run(state, dyn_zero())
    assert np.allclose(np.asarray(out.u[0]), 0.05, atol=1e-5)
    assert np.allclose(np.asarray(out.u[1]), 0.0, atol=1e-5)
    assert np.allclose(np.asarray(out.rho), 1.0, atol=1e-5)


def test_solid_walls_no_leak():
    """A sealed solid box: fluid stays bounded, mass conserved."""
    shape = (10, 10, 10)
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=False, storage="f32")
    flags = np.zeros(shape, dtype=np.uint8)
    flags[0] = flags[-1] = TYPE_S
    flags[:, 0] = flags[:, -1] = TYPE_S
    flags[:, :, 0] = flags[:, :, -1] = TYPE_S
    state = _random_smooth_state(shape, config, amp=0.01)
    state = state._replace(flags=jnp.asarray(flags))
    fluid = np.asarray(flags) == 0
    mass0 = float(np.sum(np.asarray(state.rho)[fluid]))
    run = make_multi_step(config, n_inner=200)
    out = run(state, dyn_zero())
    mass1 = float(np.sum(np.asarray(out.rho)[fluid]))
    assert abs(mass1 - mass0) / mass0 < 1e-4
    assert float(jnp.max(jnp.abs(out.u))) < 0.05


def test_thermal_diffusion_rate():
    """D3Q7 sine-wave temperature decay.

    True effective diffusivity is cs_T^2 (tau_T - 1/2) with cs_T^2 = 1/4,
    i.e. alpha/2 under the reference's w_T = 1/(2 alpha + 1/2) mapping
    (documented parity quirk, see lattice.omega_t_from_alpha)."""
    N = 32
    alpha = 0.05
    shape = (4, 4, N)
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=False, thermal=True,
                        omega_t=omega_t_from_alpha(alpha), storage="f32")
    k = 2 * np.pi / N
    x = np.arange(N)
    T = np.ones(shape, dtype=np.float32) + 0.1 * np.sin(k * x)[None, None, :]
    state = make_initial_state(shape, config=config, T=T)
    steps = 100
    run = make_multi_step(config, n_inner=steps)
    out = run(state, dyn_zero())
    amp = float(jnp.max(jnp.abs(out.T - 1.0)))
    alpha_eff = (1.0 / config.omega_t - 0.5) / 4.0  # = alpha/2
    expected = 0.1 * np.exp(-alpha_eff * k * k * steps)
    assert abs(amp - expected) / expected < 0.02, (amp, expected)


def test_fixed_temperature_cells_hold():
    shape = (4, 4, 8)
    alpha = 0.05
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=False, thermal=True,
                        omega_t=omega_t_from_alpha(alpha), storage="f32")
    T = np.ones(shape, dtype=np.float32)
    T[:, :, 0] = 1.5
    flags = np.zeros(shape, dtype=np.uint8)
    flags[:, :, 0] = TYPE_T
    state = make_initial_state(shape, config=config, T=T, flags=flags)
    run = make_multi_step(config, n_inner=200)
    out = run(state, dyn_zero())
    T_out = np.asarray(out.T)
    assert np.allclose(T_out[:, :, 0], 1.5, atol=1e-6)
    # heat diffused into the domain
    assert T_out[:, :, 1].mean() > 1.05


def test_coriolis_rotates_flow():
    """Uniform flow + Coriolis turns the velocity vector without speed gain."""
    shape = (8, 8, 8)
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=False, storage="f32")
    u0 = np.zeros((3, *shape), dtype=np.float32)
    u0[0] = 0.02
    state = make_initial_state(shape, config=config, u=u0)
    omega_z = 1e-3
    dyn = DynParams(force=jnp.zeros(3), omega_coriolis=jnp.array([0.0, 0.0, omega_z]))
    run = make_multi_step(config, n_inner=100)
    out = run(state, dyn)
    ux = float(out.u[0].mean())
    uy = float(out.u[1].mean())
    # f = -2 rho Omega x u; with Omega=+z and u=+x the deflection is -y
    assert uy < -1e-4
    speed = np.hypot(ux, uy)
    assert abs(speed - 0.02) / 0.02 < 0.05


def test_fp16_storage_tracks_fp32():
    shape = (4, 16, 16)
    cfg32 = StepConfig(omega=omega_from_nu(0.02), subgrid=False, storage="f32")
    cfg16 = StepConfig(omega=omega_from_nu(0.02), subgrid=False, storage="f16")
    state32 = _random_smooth_state(shape, cfg32, amp=0.02)
    state16 = make_initial_state(
        shape, config=cfg16, rho=np.asarray(state32.rho), u=np.asarray(state32.u))
    out32 = make_multi_step(cfg32, n_inner=50)(state32, dyn_zero())
    out16 = make_multi_step(cfg16, n_inner=50)(state16, dyn_zero())
    err = float(jnp.max(jnp.abs(out32.u - out16.u)))
    assert err < 5e-4, err  # FP16S-style storage noise stays tiny


def test_nudge_band_geometry():
    sigma, face = build_nudge_fields((6, 10, 12), NudgeSpec(n_cells=3, inv_tau=0.1,
                                                            downstream_face=2))
    # east face excluded (downstream_face=2): cells near x=max get west/south/north/top
    assert sigma[3, 5, 0] == pytest.approx(0.1)        # on west face, full weight
    assert face[3, 5, 0] == 0
    assert sigma[3, 5, 11] == 0.0 or face[3, 5, 11] != 1  # east excluded
    assert sigma[1, 5, 5] == 0.0                        # interior untouched
    assert face[5, 5, 5] == 4 and sigma[5, 5, 5] == pytest.approx(0.1)  # top face
    # sin^2 ramp: d=1 of 3
    import math
    assert sigma[3, 5, 1] == pytest.approx(0.1 * math.sin(0.5 * math.pi * (1 - 1 / 3)) ** 2)


def test_sponge_profile_geometry():
    sig = build_sponge_profile(20, SpongeSpec(n_cells=5, inv_tau=0.2))
    assert sig[19] == 0.0          # top boundary cell itself outside (d=-1)
    assert sig[18] == pytest.approx(0.2)   # d=0 -> xi=1 -> full strength
    assert sig[14] == pytest.approx(0.0)   # d=4 -> xi=0 -> zero
    assert sig[13] == 0.0
    assert np.all(sig[:13] == 0.0)


def test_nudging_pulls_interior_toward_boundary():
    shape = (8, 8, 16)
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=False, storage="f32")
    u0 = np.zeros((3, *shape), dtype=np.float32)
    u0[0] = 0.03   # boundary target velocity
    u0[0, :, :, 4:12] = 0.0  # interior hole
    flags = np.zeros(shape, dtype=np.uint8)
    flags[:, :, 0] = flags[:, :, -1] = TYPE_E
    flags[:, 0, :] = flags[:, -1, :] = TYPE_E
    flags[-1] = TYPE_E
    flags[0] = TYPE_S
    forcing = build_forcing(shape, nudge=NudgeSpec(n_cells=6, inv_tau=0.05))
    state = make_initial_state(shape, config=config, u=u0, flags=flags)
    run = make_multi_step(config, forcing, n_inner=200)
    out = run(state, dyn_zero())
    # cells inside the band moved toward the face value
    assert float(out.u[0, 4, 4, 2]) > 0.02


def test_fp16c_codec_saturates_overflow():
    """|x| >= 2 must clamp to the largest finite FP16C value (+-1.9995...),
    not wrap to near-zero garbage (reference utilities.hpp
    float_to_half_custom's (e > 127) * 0x7FFF saturation term)."""
    from latticeurbanwind_tpu.lbm.state import decode_fp16c, encode_fp16c

    x = np.array([2.0, 3.0, 1e9, np.inf, -2.0, -1e5, -np.inf, 1.5, -0.75,
                  1.9990234375], dtype=np.float32)
    rt = decode_fp16c(encode_fp16c(x))
    max_fin = float(decode_fp16c(np.array([0x7FFF], np.uint16))[0])
    assert 1.999 < max_fin < 2.0
    # overflow lanes clamp to +-max finite
    assert np.all(rt[:4] == max_fin), rt
    assert np.all(rt[4:7] == -max_fin), rt
    # in-range lanes still round-trip exactly
    np.testing.assert_allclose(rt[7:], x[7:], rtol=0, atol=0)

    # the device codec (jnp, also traced inside the GPU kernel) agrees
    # lane-for-lane with the host (numpy) codec
    import jax

    from latticeurbanwind_tpu.lbm.state import decode_ddf, encode_ddf

    enc_dev = np.asarray(jax.jit(lambda v: encode_ddf(v, "fp16c"))(
        jnp.asarray(x)))
    np.testing.assert_array_equal(enc_dev, encode_fp16c(x))
    rt_k = np.asarray(jax.jit(lambda v: decode_ddf(encode_ddf(v, "fp16c"),
                                                   "fp16c"))(jnp.asarray(x)))
    np.testing.assert_array_equal(rt_k, rt)


def test_storage_drift_fp16c_beats_fp16s_low_velocity():
    """Low-velocity (u ~ 0.005) Taylor-Green drift per storage codec.

    The reference defaults to FP16C because its 11-bit mantissa halves the
    quantization error of the near-zero DDF-shifted populations vs FP16S
    (defines.hpp:14, kernel.cpp:864-875).  Validate: after 200 steps the
    velocity-field error vs the f32 run satisfies fp16c <= f16 (FP16S), and
    both stay well-behaved (SURVEY.md §2.5 drift validation)."""
    N = 32
    nu = 0.02
    shape = (4, N, N)
    k = 2 * np.pi / N
    z, y, x = np.meshgrid(np.arange(4), np.arange(N), np.arange(N), indexing="ij")
    U0 = 0.005
    u = np.zeros((3, *shape), dtype=np.float32)
    u[0] = U0 * np.sin(k * x) * np.cos(k * y)
    u[1] = -U0 * np.cos(k * x) * np.sin(k * y)
    rho = 1.0 - (3.0 * U0**2 / 4.0) * (np.cos(2 * k * x) + np.cos(2 * k * y))

    results = {}
    for storage in ("f32", "f16", "fp16c", "bf16"):
        config = StepConfig(omega=omega_from_nu(nu), subgrid=False,
                            storage=storage)
        state = make_initial_state(shape, config=config, rho=rho, u=u)
        run = make_multi_step(config, n_inner=200)
        out = run(state, dyn_zero())
        results[storage] = np.asarray(out.u)

    ref = results["f32"]
    scale = np.abs(ref).max()
    err = {s: np.abs(results[s] - ref).max() / scale
           for s in ("f16", "fp16c", "bf16")}
    # fp16c's extra mantissa bit must not lose to FP16S at low velocity
    assert err["fp16c"] <= err["f16"] * 1.05, err
    assert err["fp16c"] < 0.02, err
    # bf16 (8-bit mantissa) drifts more; it must still stay bounded
    assert err["bf16"] < 0.2, err


@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "fp16c"])
def test_equilibrium_state_matches_host_init(storage):
    """equilibrium_state (traced, on-device) tracks make_initial_state
    (numpy) to within one storage ULP (XLA's FMA fusion reassociates the
    feq polynomial, so last-ULP f32 differences can flip a code point),
    including the thermal lattice and every storage codec."""
    from latticeurbanwind_tpu.lbm import decode_ddf, equilibrium_state

    shape = (5, 8, 9)
    config = StepConfig(omega=1.2, storage=storage, thermal=True,
                        omega_t=omega_t_from_alpha(1e-3))
    rng = np.random.default_rng(7)
    rho = 1.0 + 0.05 * rng.standard_normal(shape).astype(np.float32)
    u = 0.08 * rng.standard_normal((3, *shape)).astype(np.float32)
    T = 1.0 + 0.1 * rng.standard_normal(shape).astype(np.float32)
    flags = rng.integers(0, 4, size=shape).astype(np.uint8)

    host = make_initial_state(shape, config=config, rho=rho, u=u,
                              flags=flags, T=T)
    dev = jax.jit(lambda r, uu, fl, tt: equilibrium_state(
        shape, config=config, rho=r, u=uu, flags=fl, T=tt))(rho, u, flags, T)

    atol = {"f32": 1e-6, "bf16": 3e-3, "f16": 6e-4, "fp16c": 4e-4}[storage]
    for name in ("fi", "gi"):
        a = np.asarray(decode_ddf(jnp.asarray(getattr(host, name)), storage))
        b = np.asarray(decode_ddf(jnp.asarray(getattr(dev, name)), storage))
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)
    np.testing.assert_array_equal(np.asarray(host.flags), np.asarray(dev.flags))
    np.testing.assert_allclose(np.asarray(host.u), np.asarray(dev.u))
    np.testing.assert_allclose(np.asarray(host.T), np.asarray(dev.T))


def test_boussinesq_buoyancy_warm_rises_cold_sinks():
    """Boussinesq coupling: with gravity on the global force vector
    (f=(0,0,-g)) and beta>0, `F -= f*beta*(T-T_avg)` (reference
    kernel.cpp:1680-1682) must push warm fluid up and cold fluid down.

    Note the reference's own LUW modes construct the LBM with fx=fy=fz=0
    (setup.cpp:4935), making buoyancy numerically inert there — this
    exercises the term itself, which deck-level physics never does."""
    shape = (24, 12, 12)
    g = 2e-4
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=False,
                        thermal=True, omega_t=omega_t_from_alpha(0.05),
                        beta=0.5, t_avg=1.0, storage="f32")
    Z, Y, X = shape
    zz = np.arange(Z)
    T = np.ones(shape, np.float32)
    # warm blob low in the box, cold blob high — both should move toward
    # mid-height under buoyancy
    T[5:9, 4:8, 4:8] = 1.2
    T[15:19, 4:8, 4:8] = 0.8
    flags = np.zeros(shape, np.uint8)
    flags[0] = flags[-1] = TYPE_S          # closed top/bottom
    state = make_initial_state(shape, config=config, T=T, flags=flags)
    dyn = DynParams(force=jnp.array([0.0, 0.0, -g], jnp.float32),
                    omega_coriolis=jnp.zeros(3))
    run = make_multi_step(config, n_inner=150)
    out = run(state, dyn)
    w = np.asarray(out.u[2])
    # gravity also accelerates the uniform background until the hydrostatic
    # gradient builds — buoyancy is the motion RELATIVE to the background
    w_bg = w[1:-1].mean()
    warm_w = w[5:9, 4:8, 4:8].mean() - w_bg
    cold_w = w[15:19, 4:8, 4:8].mean() - w_bg
    assert warm_w > 1e-5, f"warm region should rise, w={warm_w}"
    assert cold_w < -1e-5, f"cold region should sink, w={cold_w}"
    # and with beta = 0 nothing moves (gravity alone is absorbed in the
    # hydrostatic balance of the uniform-T background? no — plain gravity
    # accelerates everything; compare against T_avg-matched field instead)
    cfg0 = StepConfig(omega=config.omega, subgrid=False, thermal=True,
                      omega_t=config.omega_t, beta=0.0, t_avg=1.0,
                      storage="f32")
    out0 = make_multi_step(cfg0, n_inner=150)(
        make_initial_state(shape, config=cfg0, T=T, flags=flags), dyn)
    w0 = np.asarray(out0.u[2])
    # without coupling, a blob sees the SAME force as its surroundings at
    # the same height (the closed box develops a z-profile under uniform
    # gravity, so compare within each height band, not across bands)
    ring = np.ones((Y, X), bool)
    ring[4:8, 4:8] = False
    for zlo, zhi in ((5, 9), (15, 19)):
        blob = w0[zlo:zhi, 4:8, 4:8].mean()
        around = w0[zlo:zhi][:, ring].mean()
        assert abs(blob - around) < 2e-6, (blob, around)


def test_wall_model_free_slip_preserves_plug_flow():
    """Specular ground streaming (StepConfig.wall_model): a uniform
    horizontal flow over a flat solid floor must stay uniform (free slip) —
    plain bounce-back would dig a boundary layer within a few steps.  The
    Schumann drag is made negligible (cd ~ 0) to isolate the reflection."""
    shape = (10, 8, 16)
    u0 = 0.05
    config = StepConfig(omega=omega_from_nu(0.01), subgrid=False,
                        storage="f32", wall_model=True, wall_cd=1e-12)
    flags = np.zeros(shape, np.uint8)
    flags[0] = TYPE_S
    flags[-1] = TYPE_E     # hold the top (the periodic ceiling would drag)
    u = np.zeros((3, *shape), np.float32)
    u[0, 1:] = u0
    state = make_initial_state(shape, config=config, u=u, flags=flags)
    run = make_multi_step(config, n_inner=30)
    out = run(state, dyn_zero())
    ux = np.asarray(out.u[0][1:])           # fluid region
    assert np.allclose(ux, u0, atol=1e-5)

    # contrast: plain bounce-back decelerates the first fluid layer hard
    config_bb = StepConfig(omega=omega_from_nu(0.01), subgrid=False,
                           storage="f32")
    state_bb = make_initial_state(shape, config=config_bb, u=u, flags=flags)
    out_bb = make_multi_step(config_bb, n_inner=30)(state_bb, dyn_zero())
    assert float(np.mean(np.asarray(out_bb.u[0][1]))) < 0.8 * u0


def test_wall_model_schumann_drag_rate():
    """The Schumann stress removes horizontal momentum at the predicted
    initial rate: dP/dt = -cd * sum(rho |u_h| u_h) over the first fluid
    layer.  Measured as the momentum DIFFERENCE between a cd run and a
    cd~0 run so the periodic-ceiling bounce-back loss (shared by both)
    cancels."""
    shape = (10, 8, 16)
    u0 = 0.05
    cd = 0.02
    n = 5

    def run(cd_val):
        config = StepConfig(omega=omega_from_nu(0.01), subgrid=False,
                            storage="f32", wall_model=True, wall_cd=cd_val)
        flags = np.zeros(shape, np.uint8)
        flags[0] = TYPE_S
        u = np.zeros((3, *shape), np.float32)
        u[0, 1:] = u0
        state = make_initial_state(shape, config=config, u=u, flags=flags)
        step = jax.jit(make_step(config))
        out = state
        for _ in range(n):
            out = step(out, dyn_zero())
        return float(np.sum(np.asarray(out.rho * out.u[0])[1:]))

    loss = run(1e-12) - run(cd)
    expected_loss = n * cd * u0 * u0 * 1.0 * shape[1] * shape[2]
    assert 0.7 * expected_loss < loss < 1.3 * expected_loss


def test_wall_sides_preserves_tangential_flow():
    """Vertical-face wall model (StepConfig.wall_sides, deck building_z0):
    flow along a vertical wall keeps its tangential momentum under the
    specular sides (free slip, cd=0), loses almost all of it to stair-step
    bounce-back, and sits between the two with the tangential Schumann
    stress — the street-canyon drag fix at coarse urban cells."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm.reference import make_step

    shape = (8, 32, 16)
    u = np.zeros((3, *shape), np.float32)
    u[1] = 0.05                      # flow along y
    flags = np.zeros(shape, np.uint8)
    flags[:, :, 0] = TYPE_S          # vertical wall: the x = 0 plane
    base = StepConfig(omega=omega_from_nu(0.05), subgrid=False,
                      volume_force=True, wall_model=True, wall_cd=1e-9)
    dyn = DynParams(force=jnp.zeros(3), omega_coriolis=jnp.zeros(3))

    def run(cfg):
        st = make_initial_state(shape, config=cfg, u=u, flags=flags)
        step = jax.jit(make_step(cfg))
        for _ in range(150):
            st = step(st, dyn)
        return float(st.u[1, 4, 16, 1])     # v at the first fluid cell

    v_bb = run(base)
    v_slip = run(dataclasses.replace(base, wall_sides=True,
                                     wall_cd_sides=0.0))
    v_cd = run(dataclasses.replace(base, wall_sides=True,
                                   wall_cd_sides=0.01))
    assert v_bb < 0.015, v_bb                      # bounce-back kills it
    assert abs(v_slip - 0.05) < 1e-3, v_slip       # free slip preserves it
    assert v_bb < v_cd < v_slip, (v_bb, v_cd, v_slip)
