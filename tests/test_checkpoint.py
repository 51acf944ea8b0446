"""Checkpoint/resume: bit-exact continuation of an interrupted run."""

import numpy as np

from latticeurbanwind_tpu.lbm import (
    DynParams, StepConfig, TYPE_E, TYPE_S, make_initial_state, omega_from_nu,
)
from latticeurbanwind_tpu.run.checkpoint import (
    checkpoint_path, load_checkpoint, save_checkpoint,
)
from latticeurbanwind_tpu.run.driver import RunSettings, SolverCase, run_case
from latticeurbanwind_tpu.units import Units


def _case(tmp_path, run_nstep):
    import jax.numpy as jnp
    from latticeurbanwind_tpu.lbm import Forcing

    shape = (6, 8, 10)
    rng = np.random.default_rng(3)
    u = 0.02 * rng.standard_normal((3, *shape)).astype(np.float32)
    flags = np.zeros(shape, np.uint8)
    flags[0] = TYPE_S
    flags[-1] = TYPE_E
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=True, storage="f32")
    state = make_initial_state(shape, config=config, u=u, flags=flags)
    units = Units()
    units.set_m_kg_s(1.0, 0.1, 1.0, 20.0, 8.0, 1.225)
    return SolverCase(
        config=config, forcing=Forcing(), state=state,
        dyn=DynParams(force=jnp.zeros(3), omega_coriolis=jnp.zeros(3)),
        units=units, cell_m=20.0, parent=tmp_path, datetime="20250101000000",
        settings=RunSettings(run_nstep=run_nstep, purge_avg=8, purge_avg_stride=2,
                             checkpoint_interval=10, chunk=5),
    )


def test_checkpoint_save_load_round_trip(tmp_path):
    case = _case(tmp_path, 4)
    p = tmp_path / "x.ckpt.npz"
    save_checkpoint(p, case.state, step=7, meta={"k": 1})
    state, step, avg, samples, meta = load_checkpoint(p)
    assert step == 7 and avg is None and samples == 0 and meta == {"k": 1}
    np.testing.assert_array_equal(np.asarray(state.fi), np.asarray(case.state.fi))
    np.testing.assert_array_equal(np.asarray(state.flags), np.asarray(case.state.flags))


def test_checkpoint_fbc_round_trip(tmp_path):
    """Checkpoints written with the former loop-carried face targets
    (`fbc_*` entries) still load: the state and cursor come back and the
    face targets are ignored (the step reads them from the state)."""
    case = _case(tmp_path, 4)
    p = tmp_path / "f.ckpt.npz"
    save_checkpoint(p, case.state, step=3)
    rng = np.random.default_rng(11)
    Z, Y, X = case.state.rho.shape
    with np.load(p) as z:
        payload = {k: z[k] for k in z.files}
    for k, shp in {"uw": (Z, 3, Y), "ue": (Z, 3, Y), "us": (Z, 3, X),
                   "un": (Z, 3, X), "ut": (3, Y, X), "ub": (3, Y, X)}.items():
        payload[f"fbc_{k}"] = rng.standard_normal(shp).astype(np.float32)
    np.savez_compressed(p, **payload)

    state, step, avg, samples, _ = load_checkpoint(
        p, expect_shape=case.state.rho.shape)
    assert step == 3 and avg is None and samples == 0
    np.testing.assert_array_equal(np.asarray(state.fi),
                                  np.asarray(case.state.fi))
    np.testing.assert_array_equal(np.asarray(state.u),
                                  np.asarray(case.state.u))


def test_bf16_storage_checkpoint_round_trips_bit_exactly(tmp_path):
    """npz stores bf16 as raw void bytes; the header's dtype record must
    view-cast it back so non-f32 lbm_storage runs resume bit-exactly."""
    import jax.numpy as jnp
    from latticeurbanwind_tpu.lbm import Forcing, make_initial_state

    shape = (4, 6, 8)
    config = StepConfig(omega=omega_from_nu(0.05), storage="bf16")
    state = make_initial_state(shape, config=config,
                               u=0.02 * np.ones((3, *shape), np.float32),
                               flags=np.zeros(shape, np.uint8))
    assert state.fi.dtype == jnp.bfloat16
    p = tmp_path / "b.ckpt.npz"
    save_checkpoint(p, state, step=5)
    back, step, *_ = load_checkpoint(p)
    assert step == 5 and back.fi.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back.fi).view(np.uint16),
        np.asarray(state.fi).view(np.uint16))


def test_sharded_checkpoint_per_shard_format(tmp_path):
    """Arrays on a multi-device mesh are saved as per-shard blocks (no
    gathered global copy — the multi-host-safe layout) and reassemble
    bit-exactly, including onto a DIFFERENT mesh decomposition."""
    import jax
    from latticeurbanwind_tpu.lbm import Forcing, make_initial_state
    from latticeurbanwind_tpu.parallel import domain_mesh, shard_state

    shape = (4, 8, 8)
    config = StepConfig(omega=omega_from_nu(0.05), storage="f32")
    rng = np.random.default_rng(7)
    state = make_initial_state(
        shape, config=config,
        u=0.02 * rng.standard_normal((3, *shape)).astype(np.float32),
        flags=np.zeros(shape, np.uint8))
    ref_fi = np.asarray(state.fi)
    sharded = shard_state(state, domain_mesh((2, 2, 2)))
    assert len(sharded.fi.sharding.device_set) == 8

    p = tmp_path / "s.ckpt.npz"
    save_checkpoint(p, sharded, step=9)
    with np.load(p) as z:
        shard_keys = [k for k in z.files if k.startswith("fi@")]
        assert len(shard_keys) == 8          # one block per shard
        assert "fi" not in z.files           # no monolithic copy

    back, step, *_ = load_checkpoint(p, expect_shape=shape)
    assert step == 9
    np.testing.assert_array_equal(np.asarray(back.fi), ref_fi)
    np.testing.assert_array_equal(np.asarray(back.u), np.asarray(state.u))

    # resume under a different decomposition: re-shard the loaded state
    resharded = shard_state(back, domain_mesh((4, 2, 1)))
    np.testing.assert_array_equal(np.asarray(resharded.fi), ref_fi)


def test_load_returns_host_arrays(tmp_path):
    """Restore must NOT materialize global arrays on a device: a grid that
    only fits sharded across the mesh would OOM device 0 before the driver's
    shard_state re-shards.  Host numpy comes back; placement is the
    caller's."""
    case = _case(tmp_path, 4)
    p = tmp_path / "h.ckpt.npz"
    save_checkpoint(p, case.state, step=3)
    state, *_ = load_checkpoint(p)
    assert isinstance(state.fi, np.ndarray)
    assert isinstance(state.rho, np.ndarray)


def test_torn_multihost_save_detected(tmp_path):
    """A stale main file mixed with newer sibling shard files (rank 0 died
    between the barrier and the main-file write) must fail loudly, not
    assemble a mixed-step lattice."""
    import json

    import pytest

    case = _case(tmp_path, 4)
    p = tmp_path / "t.ckpt.npz"
    save_checkpoint(p, case.state, step=5)

    # rewrite the main header as a 2-process save at step 5, and fabricate
    # a sibling stamped with a DIFFERENT step
    with np.load(p) as z:
        payload = {k: z[k] for k in z.files}
        header = json.loads(bytes(z["header"].tobytes()).decode())
    header["n_processes"] = 2
    payload["header"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    np.savez_compressed(p, **payload)
    sib = tmp_path / "t.ckpt.npz.p1.npz"
    np.savez_compressed(
        sib, header=np.frombuffer(
            json.dumps({"version": 2, "step": 6}).encode(), np.uint8))
    with pytest.raises(ValueError, match="torn multi-host save"):
        load_checkpoint(p)
    # matching sibling step assembles fine
    np.savez_compressed(
        sib, header=np.frombuffer(
            json.dumps({"version": 2, "step": 5}).encode(), np.uint8))
    state, step, *_ = load_checkpoint(p)
    assert step == 5


def test_interrupted_sharded_run_resumes_identically(tmp_path):
    """Checkpoint written under an n_gpu split (GSPMD: the state is sharded
    over the mesh at save time) resumes identically."""
    def case(parent, run_nstep):
        c = _case(parent, run_nstep)
        c.ngpu = (1, 2, 2)   # (Dx, Dy, Dz)
        return c

    full_dir = tmp_path / "full"
    full_dir.mkdir()
    r_full = run_case(case(full_dir, 30), quiet=True)

    part_dir = tmp_path / "part"
    part_dir.mkdir()
    c1 = case(part_dir, 10)
    c1.settings.purge_avg = 0
    run_case(c1, quiet=True)
    ck = checkpoint_path(part_dir, "20250101000000")
    assert ck.exists()
    with np.load(ck) as z:
        assert any(k.startswith("fi@") for k in z.files)   # per-shard layout

    r_resumed = run_case(case(part_dir, 30), quiet=True)
    assert r_resumed.total_steps == 30
    np.testing.assert_allclose(np.asarray(r_resumed.state.fi),
                               np.asarray(r_full.state.fi), atol=1e-6)
    np.testing.assert_allclose(np.asarray(r_resumed.state.u),
                               np.asarray(r_full.state.u), atol=1e-6)


def test_interrupted_run_resumes_identically(tmp_path):
    # full run in one go
    full_dir = tmp_path / "full"
    full_dir.mkdir()
    r_full = run_case(_case(full_dir, 30), quiet=True)

    # interrupted run: first 10 steps only (checkpoint lands at step 10)
    part_dir = tmp_path / "part"
    part_dir.mkdir()
    case1 = _case(part_dir, 10)
    case1.settings.purge_avg = 0    # no averaging in the stub segment
    run_case(case1, quiet=True)
    ck = checkpoint_path(part_dir, "20250101000000")
    assert ck.exists()

    # resume to 30 with the original settings
    case2 = _case(part_dir, 30)
    r_resumed = run_case(case2, quiet=True)
    assert r_resumed.total_steps == 30
    np.testing.assert_allclose(np.asarray(r_resumed.state.u),
                               np.asarray(r_full.state.u), atol=1e-6)
    np.testing.assert_allclose(np.asarray(r_resumed.state.fi),
                               np.asarray(r_full.state.fi), atol=1e-6)
