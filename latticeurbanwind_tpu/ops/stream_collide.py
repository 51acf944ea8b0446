"""Fused D3Q19 stream-collide step for NVIDIA GPUs (Pallas, Triton route).

The same update as `lbm.reference.make_step`, written as one kernel in which
each program owns `block_x` contiguous cells of one (z, y) row:

  * it loads the 19 pulled DDFs with periodic index wrap, and the source
    solid flags the halfway bounce-back and the wall models need;
  * bounce-back and specular replacements are masked loads, so a cell pays
    for them only where a solid neighbour exists;
  * moments, forces, LES and the SRT/TRT collision run in registers;
  * each of the 19 directions is stored once, followed by `rho` and `u`.

Nothing is carried between programs: Triton blocks run in no order.  The
storage codecs are `lbm.state.encode_ddf`/`decode_ddf`, applied inside the
kernel.  Per cell update the kernel moves 2*19*s bytes of DDFs, one flags
byte, 16 bytes of fresh `rho`/`u`, and (with nudging) 5 bytes of nudge
fields; `rho`/`u` of the previous step are read only at solid and
equilibrium-boundary cells and at the nudge/sponge target rows.

Thermal configurations are not supported here; `make_runner` steps them
with the jnp tier.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..lbm.lattice import C19, CS, OPP19, SMAGORINSKY_FACTOR, W19
from ..lbm.state import (
    DynParams, Forcing, LBMState, StepConfig, TYPE_E, TYPE_S,
    decode_ddf, encode_ddf,
)

# Cells per program along x (a power of two) and warps per program: the
# fastest of 64x2, 128x4, 256x4, 256x8, 512x8 at 256^3 bf16 on an H100.
BLOCK_X = 128
NUM_WARPS = 4

_DIRS = [tuple(int(v) for v in c) for c in C19]
_MIRROR = {c: i for i, c in enumerate(_DIRS)}


def kernel_reject_reason(config: StepConfig) -> Optional[str]:
    """Why the kernel cannot step `config` (None when it can)."""
    if config.thermal:
        return "thermal (D3Q7) steps are not in the kernel"
    return None


def _block_x(X: int) -> int:
    """BLOCK_X, or the smallest power of two >= X (at least 16) below it."""
    return min(BLOCK_X, max(16, 1 << (int(X) - 1).bit_length()))


def _wrap(i, d: int, n: int):
    """(i - d) with periodic wrap into [0, n), for d in {-1, 0, 1}."""
    if d == 0:
        return i
    j = i - d
    if d > 0:
        return jnp.where(j < 0, j + n, j)
    return jnp.where(j >= n, j - n, j)


def make_pallas_step(config: StepConfig, forcing: Forcing = Forcing(), *,
                     interpret: bool = False):
    """Build `step(state, dyn) -> state` running the fused kernel.

    The returned state has current `rho` and `u`, like the jnp step.
    `interpret=True` runs the kernel through the Pallas interpreter (CPU
    tests); otherwise it compiles through Triton and needs a GPU."""
    reason = kernel_reject_reason(config)
    if reason is not None:
        raise ValueError(f"stream-collide kernel: {reason}")
    use_force = config.volume_force
    has_nudge = forcing.nudge_sigma is not None
    has_sponge = forcing.sponge_sigma_z is not None
    if not use_force and (has_nudge or has_sponge):
        raise ValueError("volume_force=False requires no nudge/sponge forcing")
    storage = config.storage
    wall_model, wall_sides = config.wall_model, config.wall_sides
    side_drag = wall_sides and config.wall_cd_sides > 0.0

    def step(state: LBMState, dyn: DynParams) -> LBMState:
        if state.gi is not None:
            raise ValueError("stream-collide kernel: thermal state given")
        Z, Y, X = (int(v) for v in state.rho.shape)
        bx = _block_x(X)
        params = jnp.concatenate([
            jnp.asarray(dyn.force, jnp.float32).reshape(3),
            jnp.asarray(dyn.omega_coriolis, jnp.float32).reshape(3),
            jnp.zeros((2,), jnp.float32)])

        def kernel(*refs):
            it = iter(refs)
            fi_ref, flags_ref, rho_ref, u_ref, p_ref = (next(it) for _ in range(5))
            nsig_ref = next(it) if has_nudge else None
            nface_ref = next(it) if has_nudge else None
            sz_ref = next(it) if has_sponge else None
            fo_ref, rho_o_ref, u_o_ref = next(it), next(it), next(it)

            z = pl.program_id(2)
            y = pl.program_id(1)
            xs = pl.program_id(0) * bx + jnp.arange(bx, dtype=jnp.int32)
            inb = xs < X

            def at(c):
                cx, cy, cz = c
                return _wrap(z, cz, Z), _wrap(y, cy, Y), _wrap(xs, cx, X)

            def load(ref, idx, mask):
                return pltriton.load(ref.at[idx], mask=mask, other=0)

            def raw(i, c, mask):
                """Stored f_prev[i] at the cell the shift c pulls from."""
                zz, yy, xx = at(c)
                return load(fi_ref, (i, zz, yy, xx), mask)

            flag_cache = {}

            def solid_at(c):
                if c not in flag_cache:
                    zz, yy, xx = at(c)
                    flag_cache[c] = (load(flags_ref, (zz, yy, xx), inb)
                                     & TYPE_S) != 0
                return flag_cache[c]

            own = load(flags_ref, (z, y, xs), inb)
            solid = (own & TYPE_S) != 0
            eqbc = (own & TYPE_E) != 0
            keep = solid | eqbc
            fluid = ~solid
            not_e = ~eqbc
            zero = jnp.zeros((bx,), jnp.float32)

            # --- pull streaming with halfway bounce-back / specular walls ---
            f = [decode_ddf(raw(0, (0, 0, 0), inb), storage)]
            for i in range(1, 19):
                c = _DIRS[i]
                cx, cy, cz = c
                src_solid = solid_at(c)
                # choices in the reference's priority: z mirror, x, y, then
                # plain bounce-back; each replacement is a masked load
                picks = []
                taken = ~src_solid
                if wall_model and cz == 1:
                    t = src_solid & ~solid_at((cx, cy, 0))
                    picks.append((t, _MIRROR[(cx, cy, -1)], (cx, cy, 0)))
                    taken = taken | t
                if wall_sides and cx != 0 and (-cx, cy, cz) in _MIRROR:
                    t = ~taken & ~solid_at((0, cy, cz))
                    picks.append((t, _MIRROR[(-cx, cy, cz)], (0, cy, cz)))
                    taken = taken | t
                if wall_sides and cy != 0 and (cx, -cy, cz) in _MIRROR:
                    t = ~taken & ~solid_at((cx, 0, cz))
                    picks.append((t, _MIRROR[(cx, -cy, cz)], (cx, 0, cz)))
                    taken = taken | t
                picks.append((~taken, int(OPP19[i]), (0, 0, 0)))
                # select the stored bits, then decode once per direction
                v = raw(i, c, inb & ~src_solid)
                for t, src, sh in picks:
                    v = jnp.where(t, raw(src, sh, inb & t), v)
                f.append(decode_ddf(v, storage))

            # --- moments and equilibrium-boundary override ------------------
            rho_m = 1.0 + sum(f[1:], f[0])
            mom = [zero, zero, zero]
            for i in range(1, 19):
                for a in range(3):
                    if _DIRS[i][a] == 1:
                        mom[a] = mom[a] + f[i]
                    elif _DIRS[i][a] == -1:
                        mom[a] = mom[a] - f[i]
            rho_old = load(rho_ref, (z, y, xs), inb & keep)
            u_old = [load(u_ref, (a, z, y, xs), inb & keep) for a in range(3)]
            if config.equilibrium_boundaries:
                rhon = jnp.where(eqbc, rho_old, rho_m)
                un = [jnp.where(eqbc, u_old[a], mom[a] / rho_m)
                      for a in range(3)]
            else:
                rhon = rho_m
                un = [mom[a] / rho_m for a in range(3)]

            # --- volume forces ------------------------------------------------
            if use_force:
                ox, oy, oz = p_ref[3], p_ref[4], p_ref[5]
                F = [p_ref[0] - 2.0 * rhon * (oy * un[2] - oz * un[1]),
                     p_ref[1] - 2.0 * rhon * (oz * un[0] - ox * un[2]),
                     p_ref[2] - 2.0 * rhon * (ox * un[1] - oy * un[0])]
                if wall_model:
                    ga = (fluid & solid_at((0, 0, 1))).astype(jnp.float32)
                    uh = jnp.sqrt(un[0] * un[0] + un[1] * un[1])
                    cw = config.wall_cd * ga * rhon * uh
                    F[0] = F[0] - cw * un[0]
                    F[1] = F[1] - cw * un[1]
                    if side_drag:
                        gx = (fluid & (solid_at((1, 0, 0))
                                       | solid_at((-1, 0, 0)))).astype(jnp.float32)
                        gy = (fluid & (solid_at((0, 1, 0))
                                       | solid_at((0, -1, 0)))).astype(jnp.float32)
                        ut_x = jnp.sqrt(un[1] * un[1] + un[2] * un[2])
                        ut_y = jnp.sqrt(un[0] * un[0] + un[2] * un[2])
                        cs = config.wall_cd_sides * rhon
                        cwx = cs * gx * ut_x
                        cwy = cs * gy * ut_y
                        F[0] = F[0] - cwy * un[0]
                        F[1] = F[1] - cwx * un[1]
                        F[2] = F[2] - (cwx * un[2] + cwy * un[2])
                if has_nudge:
                    # targets read the previous step's stored field at the
                    # face cell (0=w, 1=e, 2=s, 3=n, 4=top), as the jnp step
                    nsig = load(nsig_ref, (z, y, xs), inb)
                    face = load(nface_ref, (z, y, xs), inb).astype(jnp.int32)
                    sig = jnp.where(not_e, nsig, 0.0)
                    live = inb & (sig != 0.0)
                    zt = jnp.where(face == 4, Z - 1, z)
                    yt = jnp.where(face == 2, 0, jnp.where(face == 3, Y - 1, y))
                    xt = jnp.where(face == 0, 0, jnp.where(face == 1, X - 1, xs))
                    n_axes = 3 if forcing.nudge_vertical else 2
                    for a in range(n_axes):
                        u_tgt = load(u_ref, (a, zt, yt, xt), live)
                        F[a] = F[a] + rhon * (sig * (u_tgt - un[a]))
                if has_sponge:
                    sz = sz_ref[z]
                    sig = jnp.where(not_e, sz, 0.0)
                    live = inb & (sz != 0.0)
                    for a in range(3):
                        u_top = load(u_ref, (a, Z - 1, y, xs), live)
                        F[a] = F[a] + rhon * sig * (u_top - un[a])
                u_star = [jnp.clip(un[a] + F[a] * (0.5 / rhon), -CS, CS)
                          for a in range(3)]
            else:
                u_star = [jnp.clip(un[a], -CS, CS) for a in range(3)]

            # --- equilibrium, Guo terms, LES ---------------------------------
            ux, uy, uz = u_star
            rhom1 = rhon - 1.0
            c3 = -3.0 * (ux * ux + uy * uy + uz * uz)
            feq, fin = [], []
            if use_force:
                uF = -(1.0 / 3.0) * (ux * F[0] + uy * F[1] + uz * F[2])
            for i in range(19):
                cx, cy, cz = _DIRS[i]
                w = float(W19[i])
                if i == 0:
                    feq.append(w * (rhom1 + rhon * (0.5 * c3)))
                    if use_force:
                        fin.append(9.0 * w * uF)
                    continue
                cu = 3.0 * (cx * ux + cy * uy + cz * uz)
                feq.append(w * (rhom1 + rhon * (0.5 * (cu * cu + c3) + cu)))
                if use_force:
                    cF = cx * F[0] + cy * F[1] + cz * F[2]
                    cu1 = cx * ux + cy * uy + cz * uz
                    fin.append(9.0 * w * (cF * (cu1 + 1.0 / 3.0) + uF))

            if config.subgrid:
                fneq = [f[i] - feq[i] for i in range(19)]
                H = {}
                for a in range(3):
                    for b in range(a, 3):
                        acc = None
                        for i in range(1, 19):
                            coeff = _DIRS[i][a] * _DIRS[i][b]
                            if coeff == 0:
                                continue
                            term = fneq[i] if coeff == 1 else -fneq[i]
                            acc = term if acc is None else acc + term
                        H[(a, b)] = acc
                Q = (H[(0, 0)] ** 2 + H[(1, 1)] ** 2 + H[(2, 2)] ** 2
                     + 2.0 * (H[(0, 1)] ** 2 + H[(0, 2)] ** 2 + H[(1, 2)] ** 2))
                tau0 = 1.0 / config.omega
                w_eff = 2.0 / (tau0 + jnp.sqrt(
                    tau0 * tau0 + SMAGORINSKY_FACTOR * jnp.sqrt(Q) / rhon))
            else:
                w_eff = jnp.full((bx,), config.omega, jnp.float32)

            # --- collision ----------------------------------------------------
            if config.collision == "srt":
                cf = 1.0 - 0.5 * w_eff
                post = [(1.0 - w_eff) * f[i] + w_eff * feq[i]
                        + (fin[i] * cf if use_force else 0.0)
                        for i in range(19)]
            else:
                wp = w_eff
                wm = 1.0 / (0.1875 / (1.0 / wp - 0.5) + 0.5)
                c_p = 0.5 - 0.25 * wp
                c_m = 0.5 - 0.25 * wm
                post = []
                for i in range(19):
                    o = int(OPP19[i])
                    v = (f[i] + 0.5 * wp * (feq[i] - f[i] + feq[o] - f[o])
                         + 0.5 * wm * (feq[i] - feq[o] - f[i] + f[o]))
                    if use_force:
                        v = v + (c_p * (fin[i] + fin[o])
                                 + c_m * (fin[i] - fin[o]))
                    post.append(v)

            for i in range(19):
                v = post[i]
                if config.equilibrium_boundaries:
                    v = jnp.where(eqbc, feq[i], v)
                v = jnp.where(solid, 0.0, v)
                pltriton.store(fo_ref.at[i, z, y, xs],
                               encode_ddf(v, storage), mask=inb)
            pltriton.store(rho_o_ref.at[z, y, xs],
                           jnp.where(keep, rho_old, rhon), mask=inb)
            for a in range(3):
                pltriton.store(u_o_ref.at[a, z, y, xs],
                               jnp.where(keep, u_old[a], u_star[a]), mask=inb)

        args = [state.fi, state.flags, state.rho, state.u, params]
        if has_nudge:
            args += [jnp.asarray(forcing.nudge_sigma, jnp.float32),
                     jnp.asarray(forcing.nudge_face)]
        if has_sponge:
            args.append(jnp.asarray(forcing.sponge_sigma_z, jnp.float32))
        out_shape = (jax.ShapeDtypeStruct(state.fi.shape, state.fi.dtype),
                     jax.ShapeDtypeStruct(state.rho.shape, jnp.float32),
                     jax.ShapeDtypeStruct(state.u.shape, jnp.float32))
        fi, rho, u = pl.pallas_call(
            kernel,
            out_shape=out_shape,
            grid=(pl.cdiv(X, bx), Y, Z),
            backend="triton",
            interpret=interpret,
            compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                    num_stages=1),
            name="luw_stream_collide",
        )(*args)
        return state._replace(fi=fi, rho=rho, u=u)

    return step
