"""Von Kármán synthetic-turbulence inlet.

Clean-room equivalent of the reference VonKarmanInletUpdater
(reference: setup.cpp:413-1150, kernel vk_inlet_apply kernel.cpp:2495-2571):

  * N <= 512 Fourier modes sampled from the von Kármán spectrum
    E(k) ~ k^4 / (1 + (kL)^2)^(17/6) over a log-spaced k band
    [2 pi/(10 L), pi / delta], isotropic directions, convective
    omega = u_ref k . conv_dir, amplitudes normalized to unit RMS, scaled by
    the per-component anisotropy gains;
  * inlet faces: west/east (with y corners), south/north (x interior), top
    (full plane), z in [1, Nz-2] for sides; face filters AUTO_SIDES /
    TARGET_INFLOW / EXCLUDE_DOWNSTREAM(_SIDES) / ALL_SIDES / ALL_SELECTED;
  * per-point sigma = TI * Uc (Uc = |u_base| or |u_base . n|) with
    vk_inlet_sigma as fallback; faces with tiny Uc are disabled;
  * per-step application: u(point) = u_base + sigma * sum_m A_m cos(k.x +
    omega t + phi); stride > 1 holds or interpolates the anchor time.

Device-side shape: the mode sum is a (P, M) cos + (P, M)@(M,) contraction
executed inside the jitted step scan — no host scatter loops.

RNG note: mode sampling uses numpy's Philox streams, not the reference's
mt19937_64, so realizations differ sample-for-sample while matching the
spectrum statistics (the reference itself documents A/B seed methodology,
AGENTS_PROJECT.md:119-145).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..lbm.state import LBMState, TYPE_E, TYPE_S

WEST, EAST, SOUTH, NORTH, TOP = range(5)
FACE_NORMALS = np.array([
    (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0), (0.0, -1.0, 0.0),
    (0.0, 0.0, -1.0),
], dtype=np.float64)
NMODES_MAX = 512

# face selection policies (reference VkInletFaceMode)
AUTO_SIDES, TARGET_INFLOW, EXCLUDE_DOWNSTREAM, EXCLUDE_DOWNSTREAM_SIDES, \
    ALL_SIDES, ALL_SELECTED = range(6)


@dataclass(frozen=True)
class VkConfig:
    enable: bool = True
    ti: float = 0.05
    sigma_lbm: float = 0.0
    L_lbm: float = 100.0
    nmodes: int = 256
    seed: int = 100
    update_stride: int = 1
    uc_norm_mean: bool = True          # NORM_MEAN vs NORMAL_COMPONENT
    same_realization_all_faces: bool = True
    stride_interpolation: bool = False
    inflow_only: bool = False
    face_mode: int = AUTO_SIDES
    anisotropy: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    downstream_face_id: int = -1       # 0..3 (W,E,S,N), -1 unknown

    def resolved_face_mode(self) -> int:
        if self.face_mode != AUTO_SIDES:
            return self.face_mode
        return EXCLUDE_DOWNSTREAM_SIDES if self.inflow_only else ALL_SIDES


class VkRuntime(NamedTuple):
    """Device-side inlet state (pytree); empty arrays when inactive."""

    idx: Tuple[np.ndarray, np.ndarray, np.ndarray]  # (z, y, x) point indices
    points: np.ndarray        # (P, 3) lattice positions (x, y, z)
    base_u: np.ndarray        # (3, P)
    sigma: np.ndarray         # (P,)
    face_of: np.ndarray       # (P,) int32
    modes_k: np.ndarray       # (5, M, 3)
    modes_omega: np.ndarray   # (5, M)
    modes_A: np.ndarray       # (5, M, 3)
    modes_phi: np.ndarray     # (5, M, 3)
    grid: Tuple[int, int, int] = (0, 0, 0)   # (Z, Y, X) of the lattice


def _opposite_side(face_id: int) -> int:
    return {WEST: EAST, EAST: WEST, SOUTH: NORTH, NORTH: SOUTH}.get(face_id, -1)


def _face_allowed(cfg: VkConfig, face_id: int) -> bool:
    mode = cfg.resolved_face_mode()
    target = _opposite_side(cfg.downstream_face_id)
    if mode == TARGET_INFLOW:
        if target >= 0 and face_id != target:
            return False
        if target < 0 and face_id == TOP and cfg.inflow_only:
            return False
    elif mode == EXCLUDE_DOWNSTREAM:
        if cfg.downstream_face_id >= 0 and face_id == cfg.downstream_face_id:
            return False
    elif mode == EXCLUDE_DOWNSTREAM_SIDES:
        if face_id == TOP:
            return False
        if cfg.downstream_face_id >= 0 and face_id == cfg.downstream_face_id:
            return False
    elif mode == ALL_SIDES:
        if face_id == TOP:
            return False
    elif face_id == TOP and cfg.inflow_only:
        return False
    return True


def _collect_points(cfg: VkConfig, flags: np.ndarray, u: np.ndarray):
    """Per-face inlet point lists following the reference's exclusive-ownership
    loops (west/east own the y corners; south/north skip them)."""
    Z, Y, X = flags.shape
    eligible = ((flags & TYPE_E) != 0) & ((flags & TYPE_S) == 0)
    faces = {}

    def take(face_id, zz, yy, xx):
        if not _face_allowed(cfg, face_id):
            return
        m = eligible[zz, yy, xx]
        faces[face_id] = (zz[m], yy[m], xx[m])

    zi = np.arange(1, Z - 1)
    # west / east: all y, z interior
    zz, yy = np.meshgrid(zi, np.arange(Y), indexing="ij")
    take(WEST, zz.ravel(), yy.ravel(), np.zeros(zz.size, dtype=int))
    take(EAST, zz.ravel(), yy.ravel(), np.full(zz.size, X - 1))
    if X > 2:
        zz, xx = np.meshgrid(zi, np.arange(1, X - 1), indexing="ij")
        take(SOUTH, zz.ravel(), np.zeros(zz.size, dtype=int), xx.ravel())
        take(NORTH, zz.ravel(), np.full(zz.size, Y - 1), xx.ravel())
    yy, xx = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
    take(TOP, np.full(yy.size, Z - 1), yy.ravel(), xx.ravel())
    return faces


def _sample_modes(cfg: VkConfig, u_ref: float, conv_dir: np.ndarray,
                  seed: int) -> Optional[dict]:
    L = cfg.L_lbm
    M = min(max(cfg.nmodes, 1), NMODES_MAX)
    if L <= 0 or M <= 0:
        return None
    k_max = math.pi / 1.0
    k_min = 2.0 * math.pi / (10.0 * L)
    if not (k_min > 0 and math.isfinite(k_min)):
        k_min = 1e-4
    if k_min >= 0.99 * k_max:
        k_min = 0.1 * k_max
    rng = np.random.default_rng(np.random.Philox(seed))
    xi = (np.arange(M) + rng.uniform(size=M)) / M
    k = np.exp(math.log(k_min) + xi * max(math.log(k_max) - math.log(k_min), 1e-6))
    zeta = 2.0 * rng.uniform(size=M) - 1.0
    az = 2.0 * math.pi * rng.uniform(size=M)
    r = np.sqrt(np.maximum(0.0, 1.0 - zeta ** 2))
    kvec = np.stack([k * r * np.cos(az), k * r * np.sin(az), k * zeta], axis=1)
    kL = k * L
    W = k ** 4 / (1.0 + kL ** 2) ** (17.0 / 6.0)
    a = np.sqrt(np.maximum(W, 0.0))
    var = 0.5 * float((a ** 2).sum())
    if var <= 0:
        return None
    A = (a / math.sqrt(var))[:, None] * np.asarray(cfg.anisotropy)[None, :]
    omega = u_ref * (kvec @ conv_dir)
    phi = 2.0 * math.pi * rng.uniform(size=(M, 3))
    return dict(k=kvec, omega=omega, A=A, phi=phi)


def _mix_seed(seed: int, face_id: int) -> int:
    x = (seed ^ (0x9E3779B97F4A7C15 * (face_id + 1))) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 33
    return x


def build_vk_runtime(cfg: VkConfig, flags: np.ndarray,
                     u: np.ndarray) -> Optional[VkRuntime]:
    """Assemble the inlet runtime from the initialized boundary fields.

    Returns None when disabled or no valid inflow faces exist."""
    if not cfg.enable or cfg.L_lbm <= 0 or cfg.nmodes <= 0:
        return None
    Z, Y, X = flags.shape
    if min(Z, Y, X) < 2:
        return None
    faces = _collect_points(cfg, flags, u)

    # per-face characteristic speed and enablement
    active = {}
    for fid, (zz, yy, xx) in faces.items():
        if len(zz) == 0:
            continue
        base = u[:, zz, yy, xx]                       # (3, P_f)
        mean_u = base.mean(axis=1)
        uc = (np.linalg.norm(mean_u) if cfg.uc_norm_mean
              else abs(float(mean_u @ FACE_NORMALS[fid])))
        if uc <= 1e-7:
            continue
        active[fid] = (zz, yy, xx, base)
    if not active:
        return None

    all_base = np.concatenate([v[3] for v in active.values()], axis=1)
    u_ref = float(np.linalg.norm(all_base, axis=0).mean())
    mean_u = all_base.mean(axis=1)
    conv = mean_u / np.linalg.norm(mean_u) if np.linalg.norm(mean_u) > 1e-7 \
        else np.array([1.0, 0.0, 0.0])

    M = min(max(cfg.nmodes, 1), NMODES_MAX)
    modes_k = np.zeros((5, M, 3), np.float32)
    modes_omega = np.zeros((5, M), np.float32)
    modes_A = np.zeros((5, M, 3), np.float32)
    modes_phi = np.zeros((5, M, 3), np.float32)
    shared = _sample_modes(cfg, u_ref, conv, cfg.seed) \
        if cfg.same_realization_all_faces else None
    for fid in active:
        m = shared if shared is not None else _sample_modes(
            cfg, u_ref, conv, _mix_seed(cfg.seed, fid))
        if m is None:
            return None
        modes_k[fid] = m["k"]
        modes_omega[fid] = m["omega"]
        modes_A[fid] = m["A"]
        modes_phi[fid] = m["phi"]

    zs, ys, xs, bases, fids, sigmas = [], [], [], [], [], []
    for fid, (zz, yy, xx, base) in active.items():
        uc_pt = (np.linalg.norm(base, axis=0) if cfg.uc_norm_mean
                 else np.abs(FACE_NORMALS[fid] @ base))
        sigma = cfg.ti * uc_pt if cfg.ti > 0 else np.full(len(zz), cfg.sigma_lbm)
        keep = sigma > 0
        zs.append(zz[keep])
        ys.append(yy[keep])
        xs.append(xx[keep])
        bases.append(base[:, keep])
        fids.append(np.full(keep.sum(), fid, np.int32))
        sigmas.append(sigma[keep])
    zi = np.concatenate(zs)
    if len(zi) == 0:
        return None
    yi = np.concatenate(ys)
    xi = np.concatenate(xs)
    points = np.stack([xi, yi, zi], axis=1).astype(np.float32)
    return VkRuntime(
        idx=(zi.astype(np.int32), yi.astype(np.int32), xi.astype(np.int32)),
        points=points,
        base_u=np.concatenate(bases, axis=1).astype(np.float32),
        sigma=np.concatenate(sigmas).astype(np.float32),
        face_of=np.concatenate(fids),
        modes_k=modes_k, modes_omega=modes_omega,
        modes_A=modes_A, modes_phi=modes_phi,
        grid=(Z, Y, X),
    )


def make_vk_pre_step(cfg: VkConfig, rt: VkRuntime, storage: str = "f32"):
    """jit-traceable pre-step: perturb the inlet velocities at step t.

    The perturbation is applied as DENSE per-face slab updates rather than a
    point scatter, since inlet points always live on the five domain faces.
    Per face we hold dense mask / base / sigma / position grids built once
    on the host from the runtime's point lists.

    The returned callable updates `state.u` on the inlet faces; the step
    (either tier) then holds those TYPE_E cells at feq(rho, u').
    """
    import jax.numpy as jnp

    stride = max(1, cfg.update_stride)
    interp = cfg.stride_interpolation and stride > 1
    kk = jnp.asarray(rt.modes_k)            # (5, M, 3)
    om = jnp.asarray(rt.modes_omega)        # (5, M)
    same = cfg.same_realization_all_faces
    face_of_np = np.asarray(rt.face_of)
    active_faces = sorted(set(int(f) for f in face_of_np))

    Z, Y, X = (int(v) for v in rt.grid)
    idx = tuple(np.asarray(a) for a in rt.idx)
    coord = {"z": idx[0], "y": idx[1], "x": idx[2]}
    size = {"z": Z, "y": Y, "x": X}
    # fid -> (u axis, slab index, row coord, col coord)
    FACE_DEF = {
        WEST: (3, 0, "z", "y"), EAST: (3, -1, "z", "y"),
        SOUTH: (2, 0, "z", "x"), NORTH: (2, -1, "z", "x"),
        TOP: (1, -1, "y", "x"),
    }

    def build():
        A_np = np.asarray(rt.modes_A)                            # (5, M, 3)
        ph_np = np.asarray(rt.modes_phi)
        # cos(theta + phi_c) = cos(theta) cos(phi_c) - sin(theta) sin(phi_c):
        # Ac/As fold the per-component phase into the amplitudes
        Ac_np = A_np * np.cos(ph_np)                             # (5, M, 3)
        As_np = A_np * np.sin(ph_np)
        kk_np = np.asarray(rt.modes_k)
        om_np = np.asarray(rt.modes_omega)
        Zg, Yg, Xg = Z, Y, X

        def face_geometry(fid):
            """Face grid -> lattice position: pos(r, c) = base + r e_r + c e_c
            (the inlet points of _collect_points lie exactly on this grid)."""
            base = np.zeros(3)
            er = np.zeros(3)
            ec = np.zeros(3)
            if fid in (WEST, EAST):
                base[0] = 0.0 if fid == WEST else Xg - 1
                er[2] = 1.0          # rows span z
                ec[1] = 1.0          # cols span y
            elif fid in (SOUTH, NORTH):
                base[1] = 0.0 if fid == SOUTH else Yg - 1
                er[2] = 1.0
                ec[0] = 1.0
            else:                    # TOP
                base[2] = Zg - 1.0
                er[1] = 1.0
                ec[0] = 1.0
            return base, er, ec

        faces = []
        for fid in active_faces:
            axis, index, rs, cs = FACE_DEF[fid]
            sel = face_of_np == fid
            R, C = size[rs], size[cs]
            rows, cols = coord[rs][sel], coord[cs][sel]
            mask = np.zeros((R, C), np.float32)
            mask[rows, cols] = 1.0
            base = np.zeros((3, R, C), np.float32)
            base[:, rows, cols] = np.asarray(rt.base_u)[:, sel]
            sig = np.zeros((R, C), np.float32)
            sig[rows, cols] = np.asarray(rt.sigma)[sel]
            R2, C2 = mask.shape

            # --- separable mode-sum factorization --------------------------
            # theta(r, c, t) = (k.base + omega t + r k.e_r) + c k.e_c, so the
            # per-point transcendental field cos(theta + phi) splits into a
            # time-dependent (M, R) cos/sin pair and a STATIC (2M, 3C) matrix
            # contracted on the MXU: O(M R) transcendentals per update
            # instead of the reference kernel's O(M R C)
            # (kernel.cpp:2495-2571 evaluates cos per point x mode).
            mid = active_faces[0] if same else fid
            gbase, ger, gec = face_geometry(fid)
            km = kk_np[mid]                              # (M, 3)
            a0 = km @ gbase                              # (M,)
            br = km @ ger
            bc = km @ gec
            cv = np.outer(bc, np.arange(C2))             # (M, C)
            CV, SV = np.cos(cv), np.sin(cv)
            Ac, As = Ac_np[mid], As_np[mid]              # (M, 3)
            ytop = np.concatenate(
                [Ac[:, i:i + 1] * CV - As[:, i:i + 1] * SV for i in range(3)],
                axis=1)                                  # (M, 3C)
            ybot = np.concatenate(
                [-(Ac[:, i:i + 1] * SV + As[:, i:i + 1] * CV) for i in range(3)],
                axis=1)
            trig = dict(
                a0=jnp.asarray(a0.astype(np.float32)),
                br=jnp.asarray(br.astype(np.float32)),
                om=jnp.asarray(om_np[mid]),
                ymat=jnp.asarray(np.concatenate([ytop, ybot], 0)
                                 .astype(np.float32)),   # (2M, 3C)
                r_idx=jnp.asarray(np.arange(R2, dtype=np.float32)),
            )
            faces.append((fid, axis, index, jnp.asarray(mask),
                          jnp.asarray(base), jnp.asarray(sig), trig))

        def face_q(fid, trig, shape2, t_float):
            R2, C2 = shape2
            u = (trig["a0"] + trig["om"] * t_float)[:, None] \
                + trig["br"][:, None] * trig["r_idx"][None, :]   # (M, R)
            xr = jnp.concatenate([jnp.cos(u), jnp.sin(u)], 0)    # (2M, R)
            q = xr.T @ trig["ymat"]                              # (R, 3C)
            return q.reshape(R2, 3, C2).swapaxes(0, 1)           # (3, R, C)

        def face_velocity(fid, trig, shape2, base, sig, t):
            """Perturbed face velocity u' = base + sigma * q(t) (3, R, C)."""
            tf = jnp.asarray(t, jnp.float32)
            anchor = jnp.floor(tf / stride) * stride

            def q_at(tv):
                return face_q(fid, trig, shape2, tv)

            if interp:
                a = (tf - anchor) / stride
                q = q_at(anchor)
                q = q + a * (q_at(anchor + stride) - q)
            else:
                q = q_at(anchor if stride > 1 else tf)
            return base + sig[None] * q

        def pre_step(state: LBMState, t) -> LBMState:
            u = state.u
            for fid, axis, index, mask, base, sig, trig in faces:
                newf = face_velocity(fid, trig, mask.shape, base, sig, t)
                if axis == 1:
                    cur = u[:, index]
                    u = u.at[:, index].set(mask[None] * newf
                                           + (1.0 - mask[None]) * cur)
                elif axis == 2:
                    cur = u[:, :, index]
                    u = u.at[:, :, index].set(mask[None] * newf
                                              + (1.0 - mask[None]) * cur)
                else:
                    cur = u[:, :, :, index]
                    u = u.at[:, :, :, index].set(mask[None] * newf
                                                 + (1.0 - mask[None]) * cur)
            return state._replace(u=u)

        return pre_step

    return build()


def vk_config_from_deck(deck, *, units, downstream_bc: str) -> VkConfig:
    """Deck keys -> VkConfig in lattice units (reference make_vk_runtime_config)."""
    mode_map = {"auto_sides": AUTO_SIDES, "target_inflow": TARGET_INFLOW,
                "exclude_downstream": EXCLUDE_DOWNSTREAM,
                "exclude_downstream_sides": EXCLUDE_DOWNSTREAM_SIDES,
                "all_sides": ALL_SIDES, "all_selected": ALL_SELECTED}
    ds_map = {"-x": 0, "+x": 1, "-y": 2, "+y": 3}
    aniso = deck.get_float_list("vk_inlet_anisotropy") or [1.0, 1.0, 1.0]
    if len(aniso) != 3 or any((not np.isfinite(v)) or v < 0 for v in aniso):
        aniso = [1.0, 1.0, 1.0]
    seed_text = deck.get_text("vk_inlet_seed", "100") or "100"
    try:
        seed = int(float(seed_text))
    except ValueError:
        # deterministic digest — Python's salted hash() would give a
        # different turbulence realization on every process run
        import hashlib

        seed = int.from_bytes(
            hashlib.sha256(seed_text.encode()).digest()[:8], "little") >> 1
    nmodes = deck.get_int("vk_inlet_nmodes", 256) or 256
    if nmodes > NMODES_MAX:
        nmodes = NMODES_MAX
    if nmodes <= 0:
        nmodes = 256
    stride = deck.get_int("vk_inlet_update_stride", 1) or 1
    return VkConfig(
        enable=bool(deck.get_bool("turb_inflow_enable", True)),
        ti=deck.get_float("vk_inlet_ti", 0.05) or 0.0,
        sigma_lbm=units.u(deck.get_float("vk_inlet_sigma", 0.0) or 0.0),
        L_lbm=units.x(deck.get_float("vk_inlet_l", 100.0) or 100.0),
        nmodes=nmodes,
        seed=seed,
        update_stride=max(1, stride),
        uc_norm_mean=(deck.get_text("vk_inlet_uc_mode", "NORM_MEAN") or "NORM_MEAN")
        .upper() != "NORMAL_COMPONENT",
        same_realization_all_faces=bool(
            deck.get_bool("vk_inlet_same_realization_all_faces", True)),
        stride_interpolation=bool(deck.get_bool("vk_inlet_stride_interpolation", False)),
        inflow_only=bool(deck.get_bool("vk_inlet_inflow_only", False)),
        face_mode=AUTO_SIDES,
        anisotropy=tuple(aniso),
        downstream_face_id=ds_map.get(downstream_bc, -1),
    )
