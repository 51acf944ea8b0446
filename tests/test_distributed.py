"""Two-process DCN smoke test for parallel/mesh.ensure_distributed.

Spawns two local CPU processes that initialize `jax.distributed` through the
LUW_COORDINATOR env contract, build the global ('z','y','x') mesh across
both processes, and run one sharded jnp-tier LBM step — covering the
multi-host code path (parallel/mesh.py:26-72) that otherwise only executes
on a real pod.  Skips when the port cannot be bound (sandboxed CI).
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    # NOTE: no jax.config/jax.devices before jax.distributed.initialize —
    # the backend must not exist yet (the JAX_PLATFORMS env var alone is
    # authoritative here)
    import jax
    import numpy as np

    sys.path.insert(0, os.environ["LUW_REPO"])
    from latticeurbanwind_tpu.parallel import domain_mesh, shard_state
    from latticeurbanwind_tpu.parallel.mesh import ensure_distributed
    from latticeurbanwind_tpu.lbm import (
        DynParams, StepConfig, make_initial_state, omega_from_nu,
    )
    from latticeurbanwind_tpu.lbm.reference import make_step

    assert ensure_distributed(), "expected multi-process init"
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4          # 2 hosts x 2 virtual devices

    mesh = domain_mesh((1, 1, 4))           # z split across both processes
    cfg = StepConfig(omega=omega_from_nu(0.05), subgrid=False)
    shape = (8, 8, 16)
    u = np.zeros((3, *shape), np.float32)
    u[0] = 0.03
    state = make_initial_state(shape, config=cfg, u=u)
    state = shard_state(state, mesh)
    import jax.numpy as jnp
    step = jax.jit(make_step(cfg))
    dyn = DynParams(force=jnp.zeros(3), omega_coriolis=jnp.zeros(3))
    out = step(state, dyn)
    # a cross-host collective actually runs (fi is z-sharded over DCN)
    total = float(jnp.sum(out.rho))
    assert np.isfinite(total)

    # multi-host checkpoint v2: every process writes its addressable
    # shards (non-zero ranks to sibling files), process 0 writes the main
    # file after the barrier, then reassembles the GLOBAL arrays from the
    # blocks — the path a real pod uses (run/checkpoint.py)
    from pathlib import Path
    from latticeurbanwind_tpu.run.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    ck = Path(os.environ["LUW_CKPT"])
    save_checkpoint(ck, out, step=7)
    if jax.process_index() == 0:
        assert ck.exists() and ck.with_name(ck.name + ".p1.s7.npz").exists()
    # a second save must commit atomically as a set: the new step-tagged
    # sibling appears, the stale one is garbage-collected only after the
    # main-file commit barrier, and the load returns the new step
    save_checkpoint(ck, out, step=9)
    if jax.process_index() == 0:
        assert ck.with_name(ck.name + ".p1.s9.npz").exists()
        # rank 1 unlinks its stale tag just after the commit barrier
        import time
        for _ in range(50):
            if not ck.with_name(ck.name + ".p1.s7.npz").exists():
                break
            time.sleep(0.1)
        assert not ck.with_name(ck.name + ".p1.s7.npz").exists()
        st2, step2, avg2, n2, meta = load_checkpoint(ck)
        assert step2 == 9 and avg2 is None
        full = np.asarray(st2.fi)
        assert full.shape == out.fi.shape
        for s in out.fi.addressable_shards:
            if s.replica_id:
                continue
            np.testing.assert_array_equal(np.asarray(s.data), full[s.index])
        assert abs(float(np.asarray(st2.rho).sum()) - total) < 1e-3
        print("CKPT OK")
    print(f"proc {jax.process_index()} OK total={total:.6f}")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dcn_smoke(tmp_path):
    try:
        port = _free_port()
    except OSError:
        pytest.skip("cannot bind a local port")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env.pop("XLA_FLAGS", None)
        env.update(
            LUW_REPO=repo,
            LUW_COORDINATOR=f"127.0.0.1:{port}",
            LUW_NUM_PROCESSES="2",
            LUW_PROCESS_ID=str(pid),
            LUW_CKPT=str(tmp_path / "dcn.ckpt.npz"),
            PYTHONPATH=repo,
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert "OK total=" in out, out
    # both processes computed the same global reduction
    t0 = outs[0].split("OK total=")[1].split()[0]
    t1 = outs[1].split("OK total=")[1].split()[0]
    assert t0 == t1
