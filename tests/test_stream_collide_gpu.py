"""Fused stream-collide kernel compiled for the GPU (Triton), against the
jnp step.  Marked `gpu`: skipped without a card; `python chip_smoke.py`
runs these on the card."""

import jax
import numpy as np
import pytest

from latticeurbanwind_tpu.lbm import make_step
from latticeurbanwind_tpu.lbm.stepper import make_runner
from latticeurbanwind_tpu.ops.stream_collide import make_pallas_step

from kernel_cases import make_case, ulp16


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["f32", "fp16c"])
def test_compiled_kernel_matches_reference(storage):
    """One step of the fullest physics (TRT, LES, Guo, nudge, sponge, both
    wall models) at an odd shape (masked block tails, periodic wrap):
    f32 within 1e-6; 16-bit storage within one storage ulp, or within
    1e-6 absolute where a near-zero value spans many ulps."""
    cfg, forcing, state, dyn = make_case((9, 14, 75), storage,
                                         "trt_side_walls")
    ref = jax.jit(make_step(cfg, forcing))(state, dyn)
    out = jax.jit(make_pallas_step(cfg, forcing))(state, dyn)
    from latticeurbanwind_tpu.lbm import decode_ddf

    d = np.abs(np.asarray(decode_ddf(out.fi, storage))
               - np.asarray(decode_ddf(ref.fi, storage)))
    if storage == "f32":
        assert float(d.max()) <= 1e-6
    else:
        assert bool(((ulp16(out.fi, ref.fi) <= 1) | (d <= 1e-6)).all())
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_runner_steps_the_kernel_on_gpu():
    cfg, forcing, state, dyn = make_case((9, 14, 75), "bf16",
                                         "trt_les_nudge_sponge")
    run, impl = make_runner(cfg, forcing, n_inner=5, donate=False)
    assert impl == "pallas"
    ref, _ = make_runner(cfg, forcing, n_inner=5, donate=False,
                         impl="reference")
    out = run(state, dyn, 0)
    want = ref(state, dyn, 0)
    assert np.isfinite(np.asarray(out.u)).all()
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(want.u),
                               atol=2e-3, rtol=0)
