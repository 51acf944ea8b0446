"""Fused stream-collide kernel, interpret mode: wall models, boundaries
without equilibrium override, masked block edges and periodic wrap."""

import jax
import numpy as np
import pytest

from latticeurbanwind_tpu.lbm import StepConfig, make_step
from latticeurbanwind_tpu.ops.stream_collide import (
    _block_x, kernel_reject_reason, make_pallas_step,
)

from kernel_cases import assert_states_agree, make_case

STORAGES = ["f32", "bf16", "f16", "fp16c"]


@pytest.mark.parametrize("variant", [
    "srt_ground_wall", "trt_side_walls", "srt_no_eqbc"])
@pytest.mark.parametrize("storage", STORAGES)
def test_kernel_matches_reference_walls(storage, variant):
    cfg, forcing, state, dyn = make_case((5, 7, 12), storage, variant, seed=1)
    ref = jax.jit(make_step(cfg, forcing))(state, dyn)
    out = jax.jit(make_pallas_step(cfg, forcing, interpret=True))(state, dyn)
    assert_states_agree(out, ref, storage)


@pytest.mark.parametrize("shape", [
    (3, 4, 129),     # one full 128-cell block and a 1-cell masked tail
    (2, 3, 300),     # three blocks, the last a third full
    (2, 2, 5),       # X below the smallest block: one masked block
    (3, 4, 1),       # X = 1: every x pull wraps onto the cell itself
])
def test_kernel_masked_edges_and_wrap(shape):
    cfg, forcing, state, dyn = make_case(shape, "f32", "trt_side_walls",
                                         seed=2)
    ref = jax.jit(make_step(cfg, forcing))(state, dyn)
    out = jax.jit(make_pallas_step(cfg, forcing, interpret=True))(state, dyn)
    assert_states_agree(out, ref, "f32")


def test_kernel_multi_step_matches_reference():
    """Ten steps: rho/u fed back through the equilibrium boundaries, the
    nudge targets and the sponge stay within 1e-5 of the jnp tier."""
    cfg, forcing, state, dyn = make_case((5, 6, 20), "f32",
                                         "trt_les_nudge_sponge", seed=3)

    def loop(stepf):
        return jax.jit(lambda s: jax.lax.fori_loop(
            0, 10, lambda i, x: stepf(x, dyn), s))

    ref = loop(make_step(cfg, forcing))(state)
    out = loop(make_pallas_step(cfg, forcing, interpret=True))(state)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(out.fi), np.asarray(ref.fi),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("X,want", [(1, 16), (20, 32), (128, 128),
                                    (333, 128)])
def test_block_width_is_a_power_of_two(X, want):
    assert _block_x(X) == want


def test_thermal_is_refused():
    cfg = StepConfig(omega=1.5, thermal=True, omega_t=1.2)
    assert "thermal" in kernel_reject_reason(cfg)
    assert kernel_reject_reason(StepConfig(omega=1.5)) is None
    with pytest.raises(ValueError, match="thermal"):
        make_pallas_step(cfg)


def test_forcing_without_volume_force_is_refused():
    cfg, forcing, _, _ = make_case((4, 4, 8), "f32", "trt_les_nudge_sponge")
    bare = StepConfig(omega=1.5, volume_force=False)
    with pytest.raises(ValueError, match="volume_force"):
        make_pallas_step(bare, forcing)
