"""Shared cases for the fused stream-collide kernel tests: random states,
forcing fields and the per-storage comparison against the jnp step."""

import numpy as np

from latticeurbanwind_tpu.lbm import (
    DynParams, Forcing, StepConfig, TYPE_E, TYPE_S, decode_ddf,
    make_initial_state,
)

# physics variants: (name, StepConfig kwargs, forcing kind, dynamic force)
VARIANTS = {
    "srt_les_eq": (dict(collision="srt", volume_force=False), None, False),
    "trt_bare": (dict(collision="trt", subgrid=False, volume_force=False),
                 None, False),
    "srt_guo_coriolis": (dict(collision="srt"), None, True),
    "trt_les_nudge_sponge": (dict(collision="trt"), "nudge_sponge", True),
    "srt_ground_wall": (dict(collision="srt", wall_model=True,
                             wall_cd=0.0134), "sponge", True),
    "trt_side_walls": (dict(collision="trt", wall_model=True, wall_cd=0.0134,
                            wall_sides=True, wall_cd_sides=0.004),
                       "nudge_sponge", True),
    "srt_no_eqbc": (dict(collision="srt", equilibrium_boundaries=False),
                    "nudge", True),
}


def make_case(shape, storage, variant, seed=0):
    """(config, forcing, state, dyn) with scattered solids, equilibrium
    faces and random velocities, so every branch of the step is live."""
    kw, forcing_kind, dyn_force = VARIANTS[variant]
    cfg = StepConfig(omega=1.8, storage=storage, **kw)
    Z, Y, X = shape
    rng = np.random.default_rng(seed)
    flags = np.zeros(shape, np.uint8)
    flags[rng.random(shape) < 0.12] = TYPE_S
    flags[0] = TYPE_S
    flags[-1] = TYPE_E
    flags[:, :, 0] = TYPE_E
    u = (0.04 * rng.standard_normal((3, *shape))).astype(np.float32)
    rho = (1.0 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    state = make_initial_state(shape, config=cfg, u=u, rho=rho, flags=flags)

    forcing = Forcing()
    if forcing_kind:
        import jax.numpy as jnp

        nsig = nface = spz = None
        if "nudge" in forcing_kind:
            nsig = np.zeros(shape, np.float32)
            face = np.zeros(shape, np.int8)
            nsig[:, :, :2] = 0.1                      # west band
            nsig[:, :, -2:] = 0.05                    # east band
            face[:, :, -2:] = 1
            nsig[:, :1, 2:-2] = 0.2                   # south band
            face[:, :1, 2:-2] = 2
            nsig[:, -1:, 2:-2] = 0.15                 # north band
            face[:, -1:, 2:-2] = 3
            nsig[-2:-1] = np.maximum(nsig[-2:-1], 0.08)   # below the top
            face[-2:-1] = np.where(nsig[-2:-1] == 0.08, 4, face[-2:-1])
            nsig, nface = jnp.asarray(nsig), jnp.asarray(face)
        if "sponge" in forcing_kind:
            spz = np.zeros(Z, np.float32)
            spz[-2:] = (0.1, 0.3)
            spz = jnp.asarray(spz)
        forcing = Forcing(nudge_sigma=nsig, nudge_face=nface,
                          nudge_vertical=variant.startswith("trt"),
                          sponge_sigma_z=spz)
    if dyn_force:
        dyn = DynParams(force=np.array([2e-5, -1e-5, 0.0], np.float32),
                        omega_coriolis=np.array([0.0, 1e-4, 2e-4], np.float32))
    else:
        dyn = DynParams(force=np.zeros(3, np.float32),
                        omega_coriolis=np.zeros(3, np.float32))
    return cfg, forcing, state, dyn


def ulp16(a, b):
    """Distance in storage ulps between two 16-bit DDF arrays (bf16, f16
    and fp16c are all sign-magnitude with the sign in bit 15)."""
    def ordered(x):
        x = np.asarray(x).view(np.uint16).astype(np.int32)
        return np.where(x & 0x8000, -(x & 0x7FFF), x & 0x7FFF)
    return np.abs(ordered(a) - ordered(b))


def assert_states_agree(out, ref, storage):
    """One step of the kernel against one step of the jnp tier.

    f32 storage: |df| <= 1e-6 (f32 arithmetic in another order).  16-bit
    storage: at most one storage ulp apart, since a last-bit difference of
    the f32 result can round to the neighbouring code.  rho/u: 1e-6."""
    if storage == "f32":
        np.testing.assert_allclose(np.asarray(out.fi), np.asarray(ref.fi),
                                   atol=1e-6, rtol=0)
    else:
        assert int(ulp16(out.fi, ref.fi).max()) <= 1
    np.testing.assert_allclose(np.asarray(out.rho), np.asarray(ref.rho),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(np.asarray(out.flags), np.asarray(ref.flags))
    assert np.isfinite(np.asarray(decode_ddf(out.fi, storage))).all()
