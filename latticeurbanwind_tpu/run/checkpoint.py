"""Solver checkpoint/resume — a capability the reference lacks entirely
(SURVEY.md §5: a killed run restarts from step 0).

Serializes the complete lattice state (DDFs, fields, flags, thermal arrays),
the Welford accumulator, probe time-series buffers, and the run cursor so a
run continues bit-exactly from the saved step.  Loading validates the saved
grid shape against the current case and raises a clear ValueError on
mismatch (the driver falls back to a fresh start).

Sharding-aware (format v2): arrays living on a multi-device mesh are saved
as PER-SHARD blocks keyed by their global offsets instead of one gathered
copy — no full-state host materialization, and it works on multi-host pods
where the global array is not addressable from any single process:

  * single process: all shard blocks land in the one `.ckpt.npz`;
  * multi-host: every process writes its addressable shards to a
    step-tagged sibling `<name>.p<k>.s<step>.npz` on the (shared)
    filesystem; process 0 writes the main file (header + host-side payload
    + its own shards) after a cross-process barrier, and stale sibling tags
    are garbage-collected only after a second barrier confirms the commit.
    The previous complete checkpoint set is therefore never touched until
    the new one is fully loadable — a crash anywhere in the save window
    leaves a consistent set on disk.

Restore assembles the global arrays from the blocks and returns ordinary
(unsharded) device arrays; the driver re-shards them onto the CURRENT mesh
(run/driver.py calls shard_state after the load), so a checkpoint written
under one (Dx, Dy, Dz) split resumes under any other.

Storage dtypes (bf16/f16) are not native npz dtypes — they round-trip as
raw void bytes; the header records every array's true dtype and the loader
view-casts back, keeping resume bit-exact for all lbm_storage modes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..lbm.state import LBMState
from .welford import AvgState

FORMAT_VERSION = 2


def checkpoint_path(parent: Path, datetime_tag: str, prefix: str = "") -> Path:
    return (Path(parent) / "proj_temp" / "checkpoints"
            / f"{prefix}{datetime_tag}.ckpt.npz")


_SHARD_SEP = "@"   # shard block key: "<name>@<start0>_<start1>_..."


def _sibling_path(path: Path, process_index: int,
                  step: Optional[int] = None) -> Path:
    """Per-process shard file.  Step-tagged (`.p<k>.s<step>.npz`) so a save
    in progress never touches the previous complete checkpoint set: siblings
    for the NEW step coexist with the old ones until process 0 commits the
    main file, after which the stale tags are garbage-collected.  The
    untagged name (`.p<k>.npz`) is the legacy pre-tag format, still read."""
    tag = "" if step is None else f".s{int(step)}"
    return path.with_name(f"{path.name}.p{process_index}{tag}.npz")


def _gc_siblings(path: Path, process_index: int, keep_step: int) -> None:
    """Remove this process's stale sibling files after a committed save."""
    keep = _sibling_path(path, process_index, keep_step).name
    for old in path.parent.glob(f"{path.name}.p{process_index}*.npz"):
        if old.name != keep:
            try:
                old.unlink()
            except OSError:
                pass


def _is_sharded(v) -> bool:
    import jax

    return isinstance(v, jax.Array) and len(v.sharding.device_set) > 1


def _restore_dtype(arr: np.ndarray, dtype_name: Optional[str]) -> np.ndarray:
    """Undo npz's void-byte storage of non-native dtypes (bf16, fp8, ...)."""
    if dtype_name is None or arr.dtype.name == dtype_name:
        return arr
    import ml_dtypes  # registered custom dtypes (jax dependency)

    return arr.view(np.dtype(dtype_name))


def save_checkpoint(path: Path, state: LBMState, *, step: int,
                    avg: Optional[AvgState] = None,
                    avg_samples: int = 0,
                    probes: Optional[list] = None,
                    meta: Optional[dict] = None) -> Path:
    import jax

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    arrays: Dict[str, object] = {
        "fi": state.fi, "rho": state.rho, "u": state.u, "flags": state.flags,
    }
    if state.gi is not None:
        arrays["gi"] = state.gi
        arrays["T"] = state.T
    if avg is not None:
        arrays["avg_mean_u"] = avg.mean_u
        arrays["avg_m2_u"] = avg.m2_u
        arrays["avg_mean_rho"] = avg.mean_rho
        if avg.mean_T is not None:
            arrays["avg_mean_T"] = avg.mean_T

    plain: Dict[str, np.ndarray] = {}      # written by process 0 only
    shards: Dict[str, np.ndarray] = {}     # this process's shard blocks
    global_shapes: Dict[str, list] = {}
    dtypes: Dict[str, str] = {}
    for name, v in arrays.items():
        if _is_sharded(v):
            global_shapes[name] = list(v.shape)
            dtypes[name] = np.dtype(v.dtype).name
            for s in v.addressable_shards:
                if s.replica_id:      # replicated shard: one copy suffices
                    continue
                starts = "_".join(str(int(sl.start or 0)) for sl in s.index)
                shards[f"{name}{_SHARD_SEP}{starts}"] = np.asarray(s.data)
        else:
            a = np.asarray(v)
            dtypes[name] = a.dtype.name
            plain[name] = a

    if avg is not None:
        plain["avg_count"] = np.asarray(int(avg.count))
    n_probes = 0
    if probes:
        for i, p in enumerate(probes):
            plain[f"probe{i}_times"] = np.asarray(p.times_si, dtype=np.float64)
            plain[f"probe{i}_series"] = (
                np.stack(p.series) if p.series
                else np.zeros((0, len(p.heights_si), 3), dtype=np.float64))
        n_probes = len(probes)

    n_proc = jax.process_count()
    header = {
        "version": FORMAT_VERSION,
        "step": int(step),
        "avg_samples": int(avg_samples),
        "thermal": state.gi is not None,
        "shape": list(state.rho.shape),
        "n_probes": n_probes,
        "n_processes": n_proc,
        "global_shapes": global_shapes,
        "dtypes": dtypes,
        "meta": meta or {},
    }

    def _write(target: Path, payload: Dict[str, np.ndarray]) -> None:
        tmp = target.with_suffix(".tmp.npz")
        np.savez_compressed(tmp, **payload)
        tmp.replace(target)

    if n_proc > 1:
        # Atomic-as-a-set protocol: siblings go to step-TAGGED names (never
        # overwriting the previous checkpoint's siblings), then a barrier,
        # then process 0 commits the main file (whose header step selects
        # the matching sibling tags at load), then a second barrier, then
        # every process garbage-collects its stale tags.  A crash at any
        # point leaves either the old complete set or the new complete set
        # loadable — never a torn mix.
        from jax.experimental import multihost_utils

        if jax.process_index() != 0:
            # the embedded step stamp is kept as a belt-and-braces check
            # for legacy untagged files
            sib = dict(shards)
            sib["header"] = np.frombuffer(json.dumps(
                {"version": FORMAT_VERSION, "step": int(step)}).encode(),
                dtype=np.uint8)
            _write(_sibling_path(path, jax.process_index(), step), sib)
        multihost_utils.sync_global_devices("luw_checkpoint_shards")
        if jax.process_index() == 0:
            payload = dict(plain)
            payload.update(shards)
            payload["header"] = np.frombuffer(
                json.dumps(header).encode(), dtype=np.uint8)
            _write(path, payload)
        multihost_utils.sync_global_devices("luw_checkpoint_commit")
        if jax.process_index() != 0:
            _gc_siblings(path, jax.process_index(), step)
        return path
    payload = dict(plain)
    payload.update(shards)
    payload["header"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    _write(path, payload)
    return path


def _read_header(z) -> dict:
    return json.loads(bytes(z["header"].tobytes()).decode())


def _assemble(path: Path, z, header: dict, want=None) -> Dict[str, np.ndarray]:
    """Read `want` (or all) array entries from a checkpoint: plain keys as-is,
    shard blocks placed into global buffers at their offset keys; sibling
    per-process files merged in.  Dtypes restored from the header."""
    gshapes = header.get("global_shapes") or {}
    dtypes = header.get("dtypes") or {}

    def wanted(name: str) -> bool:
        return want is None or name in want

    out: Dict[str, np.ndarray] = {}

    def take(zf) -> None:
        for key in zf.files:
            if key == "header":
                continue
            name, sep, starts = key.partition(_SHARD_SEP)
            if not wanted(name):
                continue
            if not sep:                      # plain entry
                out[name] = _restore_dtype(zf[key], dtypes.get(name))
                continue
            block = _restore_dtype(zf[key], dtypes.get(name))
            if name not in out:
                out[name] = np.empty(tuple(gshapes[name]), dtype=block.dtype)
            idx = tuple(slice(int(s), int(s) + n)
                        for s, n in zip(starts.split("_"), block.shape))
            out[name][idx] = block

    take(z)
    for i in range(1, int(header.get("n_processes") or 1)):
        # step-tagged sibling (current save protocol) first; fall back to
        # the legacy untagged name for checkpoints written by older code
        sib = _sibling_path(path, i, int(header.get("step", -1)))
        if not sib.exists():
            sib = _sibling_path(path, i)
        if not sib.exists():
            raise ValueError(f"checkpoint shard file missing: {sib} "
                             "(incomplete multi-host save?)")
        with np.load(sib) as zs:
            if "header" in zs.files:
                sh = _read_header(zs)
                if int(sh.get("step", -1)) != int(header.get("step", -1)):
                    raise ValueError(
                        f"checkpoint shard file {sib} is from step "
                        f"{sh.get('step')} but the main file is step "
                        f"{header.get('step')} — torn multi-host save "
                        "(rank 0 died before rewriting the main file?)")
            take(zs)
    return out


def load_checkpoint(path: Path, *, expect_shape=None, probes: Optional[list] = None,
                    ) -> Tuple[LBMState, int, Optional[AvgState], int, dict]:
    """Returns (state, step, avg_or_None, avg_samples, meta).

    Entries the current state does not hold (the `fbc_*` face targets that
    older checkpoints carry) are ignored.

    `expect_shape`: current case grid (Z, Y, X) — a saved checkpoint for a
    different grid raises ValueError instead of a cryptic jit shape error.
    `probes`: GridProbe list to refill with the saved sample buffers.

    Arrays come back as HOST (numpy) arrays regardless of the mesh they
    were saved under; the caller places them — the driver's shard_state
    device_puts each field with its target sharding, which transfers only
    the per-device slices (a grid that only fits sharded across the mesh
    must never be materialized on one device), and a single-device run
    commits them on first jit use.  Resume therefore works across
    different (Dx, Dy, Dz) decompositions.
    """
    path = Path(path)
    with np.load(path) as z:
        header = _read_header(z)
        if header.get("version") not in (1, FORMAT_VERSION):
            raise ValueError(
                f"unsupported checkpoint version: {header.get('version')}")
        saved_shape = tuple(header.get("shape") or z["rho"].shape)
        if expect_shape is not None and tuple(expect_shape) != saved_shape:
            raise ValueError(
                f"checkpoint grid {saved_shape} does not match case grid "
                f"{tuple(expect_shape)} — the deck changed since the save")
        arrs = _assemble(path, z, header)
    thermal = header["thermal"]
    state = LBMState(
        fi=arrs["fi"],
        rho=arrs["rho"],
        u=arrs["u"],
        flags=arrs["flags"],
        gi=arrs["gi"] if thermal else None,
        T=arrs["T"] if thermal else None,
    )
    avg = None
    if "avg_count" in arrs:
        m2 = arrs["avg_m2_u"]
        if m2.ndim == 4:       # pre-trace format stored per-component M2
            m2 = m2.sum(axis=0)
        avg = AvgState(
            count=np.asarray(int(arrs["avg_count"]), np.int32),
            mean_u=arrs["avg_mean_u"],
            m2_u=m2,
            mean_rho=arrs["avg_mean_rho"],
            mean_T=(arrs["avg_mean_T"] if "avg_mean_T" in arrs else None),
        )
    if probes is not None and header.get("n_probes"):
        n = min(len(probes), int(header["n_probes"]))
        for i in range(n):
            p = probes[i]
            p.times_si = list(arrs[f"probe{i}_times"])
            p.series = [s for s in arrs[f"probe{i}_series"]]
    return state, header["step"], avg, header["avg_samples"], header["meta"]

