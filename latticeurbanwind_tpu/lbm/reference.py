"""Pure-jnp reference LBM step: the framework's numerical ground truth.

Implements the full fused update of the reference stream_collide kernel
(reference: core/cfd_core/FluidX3D/src/kernel.cpp:1475-1780) as a functional
array program:

  pull streaming (+ implicit halfway bounce-back at solid cells)
  -> moments (DDF-shifted) -> equilibrium-boundary override
  -> Coriolis + buffer nudging + top sponge forces
  -> D3Q7 temperature sub-lattice + Boussinesq coupling
  -> Guo velocity half-step + clamp
  -> Smagorinsky-Lilly LES relaxation rate
  -> SRT/TRT collision -> storage encode.

Everything is dense masked arithmetic (`jnp.where`), no data-dependent control
flow; XLA fuses it into a few bandwidth-bound loops.  This tier favors
clarity and exactness; the GPU kernel (ops/stream_collide.py) reproduces it
per cell and is tested against it.

Parity notes vs the reference kernel:
  * double-buffered pull streaming replaces Esoteric-Pull (same physics; the
    even/odd in-place indexing is a VRAM optimization, not semantics).
  * periodic wrap at the global box edge matches the reference's modular
    neighbor indexing.
  * nudging/sponge targets read the previous step's stored velocity field —
    deterministic, and identical to the reference's in-place field read
    whenever the reference cell is a TYPE_E boundary (always true in LUW
    cases; the in-place read is scheduling-dependent otherwise).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .lattice import C19, C7, OPP19, OPP7, SMAGORINSKY_FACTOR, W19, W7, CS
from .state import (
    DynParams,
    Forcing,
    LBMState,
    StepConfig,
    TYPE_E,
    TYPE_S,
    TYPE_T,
    decode_ddf,
    encode_ddf,
)


def equilibrium_f(rho: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """DDF-shifted D3Q19 equilibrium, feq_i = w_i [(rho-1) + rho (cu + cu^2/2 - 3u^2/2)]
    with cu = 3 c_i.u (reference: kernel.cpp calculate_f_eq)."""
    rho = rho.astype(jnp.float32)
    u = u.astype(jnp.float32)
    rhom1 = rho - 1.0
    c3 = -3.0 * (u[0] * u[0] + u[1] * u[1] + u[2] * u[2])
    out = []
    for i in range(19):
        cx, cy, cz = (int(v) for v in C19[i])
        cu = 3.0 * (cx * u[0] + cy * u[1] + cz * u[2]) if (cx or cy or cz) else None
        wi = float(W19[i])
        if cu is None:
            out.append(wi * (rhom1 + rho * (0.5 * c3)))
        else:
            out.append(wi * (rhom1 + rho * (0.5 * (cu * cu + c3) + cu)))
    return jnp.stack(out)


def equilibrium_g(T: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """DDF-shifted D3Q7 thermal equilibrium geq_i = w_i (T-1) + 4 w_i T (c_i.u)
    (reference: kernel.cpp calculate_g_eq; D3Q7 cs^2 = 1/4)."""
    T = T.astype(jnp.float32)
    u = u.astype(jnp.float32)
    Tm1 = T - 1.0
    out = [0.25 * Tm1]
    for i in range(1, 7):
        cx, cy, cz = (int(v) for v in C7[i])
        cu = cx * u[0] + cy * u[1] + cz * u[2]
        out.append(0.125 * Tm1 + 0.5 * T * cu)
    return jnp.stack(out)


def moments(f: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Density and velocity from DDF-shifted populations: rho = 1 + sum f."""
    rho = 1.0 + jnp.sum(f, axis=0)
    mom = [jnp.zeros_like(rho) for _ in range(3)]
    for i in range(1, 19):
        for a in range(3):
            c = int(C19[i, a])
            if c == 1:
                mom[a] = mom[a] + f[i]
            elif c == -1:
                mom[a] = mom[a] - f[i]
    u = jnp.stack(mom) / rho
    return rho, u


def _pull(field: jnp.ndarray, c) -> jnp.ndarray:
    """Pull-shift: result[z,y,x] = field[z-cz, y-cy, x-cx] (periodic)."""
    cx, cy, cz = (int(v) for v in c)
    if cx == 0 and cy == 0 and cz == 0:
        return field
    return jnp.roll(field, shift=(cz, cy, cx), axis=(0, 1, 2))


def _stream(f_prev: jnp.ndarray, solid: jnp.ndarray, C, OPP,
            wall_model: bool = False, wall_sides: bool = False) -> jnp.ndarray:
    """Pull streaming with halfway bounce-back from solid sources.

    wall_model=True switches upward (cz=+1) directions whose source is
    solid BELOW to halfway SPECULAR reflection off the horizontal face —
    f_(cx,cy,+1)(x) <- f_(cx,cy,-1)(x - (cx,cy,0)) — whenever that in-plane
    partner cell is fluid (corners/vertical walls keep bounce-back).  The
    Schumann shear stress in make_step restores the physical log-law drag
    the free-slip face removes.

    wall_sides=True extends the same treatment to VERTICAL faces: a
    direction with cx != 0 whose source is solid reflects about the x face
    — f_(cx,cy,cz)(x) <- f_(-cx,cy,cz)(x - (0,cy,cz)) — when that
    tangential partner is fluid (likewise about y).  Priority when several
    reflections are admissible (outer corner cells): z mirror, then x,
    then y — the later jnp.where wins, so the z (ground) mirror is applied
    last and dominates."""
    C_l = [tuple(int(v) for v in c) for c in np.asarray(C)]
    mirror = {c: i for i, c in enumerate(C_l)}
    out = [f_prev[0]]
    for i in range(1, f_prev.shape[0]):
        cx, cy, cz = C_l[i]
        pulled = _pull(f_prev[i], C[i])
        src_solid = _pull(solid, C[i])
        repl = f_prev[int(OPP[i])]
        if wall_sides and cy != 0 and (cx, -cy, cz) in mirror:
            m = mirror[(cx, -cy, cz)]
            spec = _pull(f_prev[m], (cx, 0, cz))
            nbr_solid = _pull(solid, (cx, 0, cz))
            repl = jnp.where(nbr_solid, repl, spec)
        if wall_sides and cx != 0 and (-cx, cy, cz) in mirror:
            m = mirror[(-cx, cy, cz)]
            spec = _pull(f_prev[m], (0, cy, cz))
            nbr_solid = _pull(solid, (0, cy, cz))
            repl = jnp.where(nbr_solid, repl, spec)
        if wall_model and cz == 1:
            m = mirror[(cx, cy, -1)]
            spec = _pull(f_prev[m], (cx, cy, 0))
            nbr_solid = _pull(solid, (cx, cy, 0))
            repl = jnp.where(nbr_solid, repl, spec)
        out.append(jnp.where(src_solid, repl, pulled))
    return jnp.stack(out)


def _guo_forcing_terms(u: jnp.ndarray, F: jnp.ndarray) -> jnp.ndarray:
    """Guo volume-force population terms (Krueger p.233f; reference
    calculate_forcing_terms): Fin_i = 9 w_i [(c_i.F)(c_i.u + 1/3) - (u.F)/3]."""
    uF = -(1.0 / 3.0) * (u[0] * F[0] + u[1] * F[1] + u[2] * F[2])
    out = []
    for i in range(19):
        cx, cy, cz = (int(v) for v in C19[i])
        wi = 9.0 * float(W19[i])
        if cx == 0 and cy == 0 and cz == 0:
            out.append(wi * uF)
        else:
            cF = cx * F[0] + cy * F[1] + cz * F[2]
            cu = cx * u[0] + cy * u[1] + cz * u[2]
            out.append(wi * (cF * (cu + 1.0 / 3.0) + uF))
    return jnp.stack(out)


def _les_omega(f: jnp.ndarray, feq: jnp.ndarray, rho: jnp.ndarray, omega0: float) -> jnp.ndarray:
    """Smagorinsky-Lilly effective relaxation rate from the non-equilibrium
    stress tensor (reference: kernel.cpp:1723-1737)."""
    fneq = f - feq
    H = {}
    for a in range(3):
        for b in range(a, 3):
            acc = None
            for i in range(1, 19):
                coeff = int(C19[i, a]) * int(C19[i, b])
                if coeff == 0:
                    continue
                term = fneq[i] if coeff == 1 else -fneq[i]
                acc = term if acc is None else acc + term
            H[(a, b)] = acc
    Q = (H[(0, 0)] ** 2 + H[(1, 1)] ** 2 + H[(2, 2)] ** 2
         + 2.0 * (H[(0, 1)] ** 2 + H[(0, 2)] ** 2 + H[(1, 2)] ** 2))
    tau0 = 1.0 / omega0
    return 2.0 / (tau0 + jnp.sqrt(tau0 * tau0 + SMAGORINSKY_FACTOR * jnp.sqrt(Q) / rho))


def _opp_gather(f: jnp.ndarray, OPP) -> jnp.ndarray:
    return f[np.asarray(OPP)]


def make_step(config: StepConfig, forcing: Forcing = Forcing()):
    """Build the single-step update function `step(state, dyn) -> state`.

    `config.volume_force=False` compiles the Guo forcing path out, exactly
    like the GPU kernel (and the reference's VOLUME_FORCE-off build,
    defines.hpp) — `dyn.force`/`dyn.omega_coriolis` are then ignored, so the
    build refuses configurations that would need them (nudge/sponge/thermal),
    keeping the two tiers equivalent by construction."""
    use_force = config.volume_force
    if not use_force and (forcing.nudge_sigma is not None
                          or forcing.sponge_sigma_z is not None
                          or config.thermal):
        raise ValueError("volume_force=False requires no nudge/sponge "
                         "forcing and no thermal buoyancy")

    def step(state: LBMState, dyn: DynParams) -> LBMState:
        flags = state.flags
        solid = (flags & TYPE_S) != 0
        eqbc = (flags & TYPE_E) != 0

        f_prev = decode_ddf(state.fi, config.storage)
        f = _stream(f_prev, solid, C19, OPP19, wall_model=config.wall_model,
                    wall_sides=config.wall_sides)

        rho_m, u_m = moments(f)
        if config.equilibrium_boundaries:
            rhon = jnp.where(eqbc, state.rho, rho_m)
            un = jnp.where(eqbc[None], state.u, u_m)
        else:
            rhon, un = rho_m, u_m

        # --- volume forces --------------------------------------------------
        if use_force:
            F = jnp.broadcast_to(
                dyn.force.astype(jnp.float32)[:, None, None, None], un.shape
            )
            ox, oy, oz = dyn.omega_coriolis
            cor = jnp.stack([
                -2.0 * rhon * (oy * un[2] - oz * un[1]),
                -2.0 * rhon * (oz * un[0] - ox * un[2]),
                -2.0 * rhon * (ox * un[1] - oy * un[0]),
            ])
            F = F + cor
            if config.wall_model:
                # Schumann wall stress at the first fluid cell above a
                # horizontal solid face: F = -Cd rho |u_h| u_h, Cd =
                # [kappa/ln(z1/z0)]^2 (z1 = half cell).  Pairs with the
                # specular streaming above to emulate a z0-rough wall.
                ga = ((~solid) & _pull(solid, (0, 0, 1))).astype(jnp.float32)
                uh = jnp.sqrt(un[0] * un[0] + un[1] * un[1])
                cw = config.wall_cd * ga * rhon * uh
                F = F - jnp.stack([cw * un[0], cw * un[1],
                                   jnp.zeros_like(cw)])
                if config.wall_sides and config.wall_cd_sides > 0.0:
                    # tangential Schumann stress beside vertical faces:
                    # an x face drags (v, w), a y face drags (u, w)
                    fl = ~solid
                    gx = (fl & (_pull(solid, (1, 0, 0))
                                | _pull(solid, (-1, 0, 0)))).astype(
                                    jnp.float32)
                    gy = (fl & (_pull(solid, (0, 1, 0))
                                | _pull(solid, (0, -1, 0)))).astype(
                                    jnp.float32)
                    ut_x = jnp.sqrt(un[1] * un[1] + un[2] * un[2])
                    ut_y = jnp.sqrt(un[0] * un[0] + un[2] * un[2])
                    cs = config.wall_cd_sides * rhon
                    cwx = cs * gx * ut_x
                    cwy = cs * gy * ut_y
                    F = F - jnp.stack([cwy * un[0],
                                       cwx * un[1],
                                       cwx * un[2] + cwy * un[2]])

        not_e = ~eqbc
        # Nudge/sponge targets read the previous step's stored field (state.u)
        # — deterministic, and identical to reading the current value whenever
        # the face reference cell is a TYPE_E boundary (always true in LUW
        # cases; the reference kernel's in-place field read is racy otherwise).
        up = state.u
        if forcing.nudge_sigma is not None:
            face = forcing.nudge_face
            u_tgt = up[:, :, :, 0:1]                       # west: x = 0
            u_tgt = jnp.where(face[None] == 1, up[:, :, :, -1:], u_tgt)   # east
            u_tgt = jnp.where(face[None] == 2, up[:, :, 0:1, :], u_tgt)   # south
            u_tgt = jnp.where(face[None] == 3, up[:, :, -1:, :], u_tgt)   # north
            u_tgt = jnp.where(face[None] == 4, up[:, -1:, :, :], u_tgt)   # top
            sig = jnp.where(not_e, forcing.nudge_sigma, 0.0)
            acc = sig * (u_tgt - un)
            if not forcing.nudge_vertical:
                acc = acc.at[2].set(0.0)
            F = F + rhon * acc

        if forcing.sponge_sigma_z is not None:
            sig_z = forcing.sponge_sigma_z[:, None, None]
            sig = jnp.where(not_e, sig_z, 0.0)
            u_top = state.u[:, -1:, :, :]
            F = F + rhon * sig * (u_top - un)

        # --- temperature sub-lattice ---------------------------------------
        gi_new = None
        T_new = state.T
        if config.thermal:
            tfix = (flags & TYPE_T) != 0
            g_prev = decode_ddf(state.gi, config.storage)
            g = _stream(g_prev, solid, C7, OPP7)
            T_m = 1.0 + jnp.sum(g, axis=0)
            Tn = jnp.where(tfix, state.T, T_m)
            if forcing.sponge_sigma_z is not None:
                sig_t = jnp.where(not_e & ~tfix, forcing.sponge_sigma_z[:, None, None], 0.0)
                Tn = Tn + sig_t * (state.T[-1:, :, :] - Tn)
            geq = equilibrium_g(Tn, un)
            g_post = jnp.where(tfix[None], geq, (1.0 - config.omega_t) * g + config.omega_t * geq)
            g_post = jnp.where(solid[None], 0.0, g_post)
            gi_new = encode_ddf(g_post, config.storage)
            T_new = jnp.where(solid | tfix, state.T, Tn)
            # Boussinesq buoyancy rides on the global (gravity) force vector.
            F = F - dyn.force.astype(jnp.float32)[:, None, None, None] * (
                config.beta * (Tn - config.t_avg)
            )

        # --- Guo half-step + clamp ------------------------------------------
        if use_force:
            u_star = jnp.clip(un + F * (0.5 / rhon), -CS, CS)
            fin = _guo_forcing_terms(u_star, F)
        else:
            u_star = jnp.clip(un, -CS, CS)
            fin = jnp.zeros_like(f)

        feq = equilibrium_f(rhon, u_star)

        omega_eff = (
            _les_omega(f, feq, rhon, config.omega)
            if config.subgrid
            else jnp.full_like(rhon, config.omega)
        )

        # --- collision -------------------------------------------------------
        if config.collision == "srt":
            fin = fin * (1.0 - 0.5 * omega_eff)
            f_post = (1.0 - omega_eff) * f + omega_eff * feq + fin
        else:  # trt
            wp = omega_eff
            wm = 1.0 / (0.1875 / (1.0 / wp - 0.5) + 0.5)
            fin_b = _opp_gather(fin, OPP19)
            c_taup = 0.5 - 0.25 * wp
            c_taum = 0.5 - 0.25 * wm
            fin = c_taup * (fin + fin_b) + c_taum * (fin - fin_b)
            fhb = _opp_gather(f, OPP19)
            feb = _opp_gather(feq, OPP19)
            f_post = (f + 0.5 * wp * (feq - f + feb - fhb)
                      + 0.5 * wm * (feq - feb - f + fhb) + fin)

        if config.equilibrium_boundaries:
            f_post = jnp.where(eqbc[None], feq, f_post)
        f_post = jnp.where(solid[None], 0.0, f_post)

        keep = solid | eqbc
        rho_new = jnp.where(keep, state.rho, rhon)
        u_new = jnp.where(keep[None], state.u, u_star)

        return LBMState(
            fi=encode_ddf(f_post, config.storage),
            rho=rho_new,
            u=u_new,
            flags=flags,
            gi=gi_new,
            T=T_new,
        )

    return step


def make_multi_step(config: StepConfig, forcing: Forcing = Forcing(), n_inner: int = 1):
    """`lax.scan`-chunked multi-step update; one compiled program advances
    `n_inner` steps (keeps dispatch overhead off the hot loop)."""
    step = make_step(config, forcing)

    @jax.jit
    def run(state: LBMState, dyn: DynParams) -> LBMState:
        def body(s, _):
            return step(s, dyn), None
        out, _ = jax.lax.scan(body, state, None, length=n_inner)
        return out

    return run
