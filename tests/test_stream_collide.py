"""Fused stream-collide kernel (ops/stream_collide.py), Pallas interpret
mode on the CPU, against the jnp step (lbm/reference.py): storage x
collision x LES x forcing x wall model."""

import jax
import pytest

from latticeurbanwind_tpu.lbm import make_step
from latticeurbanwind_tpu.ops.stream_collide import make_pallas_step

from kernel_cases import assert_states_agree, make_case

STORAGES = ["f32", "bf16", "f16", "fp16c"]


@pytest.mark.parametrize("variant", [
    "srt_les_eq", "trt_bare", "srt_guo_coriolis", "trt_les_nudge_sponge"])
@pytest.mark.parametrize("storage", STORAGES)
def test_kernel_matches_reference(storage, variant):
    cfg, forcing, state, dyn = make_case((5, 6, 20), storage, variant)
    ref = jax.jit(make_step(cfg, forcing))(state, dyn)
    out = jax.jit(make_pallas_step(cfg, forcing, interpret=True))(state, dyn)
    assert_states_agree(out, ref, storage)
