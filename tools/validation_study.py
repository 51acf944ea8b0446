"""Grid-convergence validation study: Taylor-Green + Poiseuille.

Produces docs/VALIDATION.md + figures.  Quantifies what the single-point
physics tests (tests/test_lbm_physics.py) check qualitatively:

  * Taylor-Green vortex decay: the measured effective viscosity converges
    to the nominal nu as the lattice resolves the vortex (diffusive-scaled,
    error ~ O(1/N^2) for SRT at fixed Mach).
  * Poiseuille channel: L2 error of the steady force-driven profile vs the
    halfway-bounce-back analytic parabola, second-order in the wall-normal
    resolution.

Run: python tools/validation_study.py  (CPU or GPU; a few minutes)
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from latticeurbanwind_tpu.lbm import (  # noqa: E402
    DynParams, StepConfig, TYPE_S, make_initial_state, make_multi_step,
    omega_from_nu,
)

DOCS = Path(__file__).resolve().parents[1] / "docs"


def taylor_green_effective_nu(N: int, nu: float = 0.01, u0: float = 0.02):
    """Effective viscosity from the decay of a z-invariant TG vortex."""
    shape = (4, N, N)
    k = 2.0 * np.pi / N
    y, x = np.meshgrid(np.arange(N) + 0.5, np.arange(N) + 0.5, indexing="ij")
    u = np.zeros((3, *shape), np.float32)
    u[0, :] = (u0 * np.cos(k * x) * np.sin(k * y))[None]
    u[1, :] = (-u0 * np.sin(k * x) * np.cos(k * y))[None]
    cfg = StepConfig(omega=omega_from_nu(nu), subgrid=False, storage="f32")
    state = make_initial_state(shape, config=cfg, u=u)
    # diffusive scaling: fixed vortex decay fraction across resolutions
    steps = max(1, int(round(0.1 / (2.0 * nu * k * k))))
    run = make_multi_step(cfg, n_inner=steps)
    out = run(state, DynParams(force=jnp.zeros(3), omega_coriolis=jnp.zeros(3)))
    e0 = float(np.sum(u[0] ** 2 + u[1] ** 2))
    e1 = float(jnp.sum(out.u[0] ** 2 + out.u[1] ** 2))
    # E(t) = E0 exp(-4 nu k^2 t)
    nu_eff = -np.log(e1 / e0) / (4.0 * k * k * steps)
    return nu_eff, abs(nu_eff - nu) / nu


def poiseuille_error(H: int, collision: str, nu: float = 0.1,
                     fx: float = 1e-6):
    """L2 profile error of a force-driven channel of height H cells.

    TRT with the reference's magic lambda = 3/16 second relaxation rate
    places the bounce-back wall exactly half a link out at any tau;
    SRT shows the classic tau-dependent wall slip (second-order in H down
    to the slip floor).
    """
    shape = (H + 2, 8, 16)     # solid planes at z=0 and z=H+1
    flags = np.zeros(shape, np.uint8)
    flags[0] = flags[-1] = TYPE_S
    cfg = StepConfig(omega=omega_from_nu(nu), collision=collision,
                     subgrid=False, storage="f32")
    state = make_initial_state(shape, config=cfg, flags=flags)
    # march well past the diffusion time: t = 6 H^2 / nu
    steps = int(6 * (H + 1) ** 2 / nu)
    run = make_multi_step(cfg, n_inner=min(steps, 4000))
    dyn = DynParams(force=jnp.array([fx, 0.0, 0.0]), omega_coriolis=jnp.zeros(3))
    done = 0
    while done < steps:
        state = run(state, dyn)
        done += min(steps, 4000)
    prof = np.array(state.u[0, :, 4, 8])
    z = np.arange(shape[0])
    # halfway bounce-back wall surfaces sit half a link beyond the last
    # fluid cells: z = 0.5 and z = H + 0.5
    zw0, zw1 = 0.5, H + 0.5
    analytic = fx / (2.0 * nu) * (z - zw0) * (zw1 - z)
    analytic[0] = analytic[-1] = 0.0
    prof[0] = prof[-1] = 0.0
    sel = slice(1, -1)
    err = np.sqrt(np.mean((prof[sel] - analytic[sel]) ** 2)) / analytic.max()
    return prof, analytic, err


def main() -> int:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    DOCS.mkdir(exist_ok=True)

    print("Taylor-Green effective viscosity:")
    tg_n = [16, 32, 64, 128]
    tg_err = []
    for N in tg_n:
        nu_eff, rel = taylor_green_effective_nu(N)
        tg_err.append(rel)
        print(f"  N={N:4d}: nu_eff={nu_eff:.6f} rel err={rel:.2e}")

    print("Poiseuille profile error:")
    po_h = [6, 12, 24, 48]
    po_err = {"srt": [], "trt": []}
    profs = {}
    for H in po_h:
        for coll in ("srt", "trt"):
            prof, analytic, err = poiseuille_error(H, coll)
            po_err[coll].append(err)
            profs[H, coll] = (prof, analytic)
            print(f"  H={H:3d} {coll}: L2/max err={err:.2e}")

    fig, axes = plt.subplots(1, 3, figsize=(16, 4.6))
    axes[0].loglog(tg_n, tg_err, "o-", label="measured")
    axes[0].loglog(tg_n, tg_err[0] * (np.asarray(tg_n) / tg_n[0]) ** -2.0,
                   "k--", label="O(N$^{-2}$)")
    axes[0].set_xlabel("N"); axes[0].set_ylabel("relative $\\nu$ error")
    axes[0].set_title("Taylor-Green viscosity convergence"); axes[0].legend()

    axes[1].loglog(po_h, po_err["srt"], "s-", label="SRT")
    axes[1].loglog(po_h, po_err["trt"], "^-", label="TRT ($\\Lambda$=3/16)")
    axes[1].loglog(po_h, po_err["srt"][0] * (np.asarray(po_h) / po_h[0]) ** -2.0,
                   "k--", label="O(H$^{-2}$)")
    axes[1].set_xlabel("channel height H (cells)")
    axes[1].set_ylabel("normalized L2 error")
    axes[1].set_title("Poiseuille profile convergence"); axes[1].legend()

    H = po_h[1]
    prof, analytic = profs[H, "trt"]
    z = np.arange(len(prof))
    axes[2].plot(analytic, z, "k-", label="analytic")
    axes[2].plot(prof, z, "o", ms=4, label="LBM")
    axes[2].set_xlabel("$u_x$ (lattice)"); axes[2].set_ylabel("z (cells)")
    axes[2].set_title(f"Poiseuille profile, H={H}"); axes[2].legend()
    fig.tight_layout()
    fig.savefig(DOCS / "validation_convergence.png", dpi=110)

    # convergence orders from the last dyad
    tg_order = np.log2(tg_err[-2] / tg_err[-1])
    po_order = np.log2(po_err["srt"][0] / po_err["srt"][1])
    trt_max = max(po_err["trt"])
    md = f"""# Solver validation: grid convergence

Generated by `tools/validation_study.py` (backend: {jax.default_backend()}).

## Taylor-Green vortex (viscosity accuracy)

Decaying 2-D Taylor-Green vortex; the kinetic-energy decay rate measures the
effective viscosity.  Error vs the nominal $\\nu$:

| N | relative error |
|---|---|
""" + "\n".join(f"| {n} | {e:.3e} |" for n, e in zip(tg_n, tg_err)) + f"""

Observed order (last dyad): **{tg_order:.2f}** (expected 2 for SRT).

## Poiseuille channel (wall accuracy)

Force-driven channel with halfway bounce-back walls; steady profile vs the
analytic parabola through the half-link wall positions:

| H (cells) | SRT error | TRT error |
|---|---|---|
""" + "\n".join(f"| {h} | {a:.3e} | {b:.3e} |"
                for h, a, b in zip(po_h, po_err["srt"], po_err["trt"])) + f"""

SRT converges at order **{po_order:.2f}** toward its tau-dependent wall-slip
floor (the classic SRT+bounce-back artifact).  TRT with the reference's
magic lambda = 3/16 parameterization (kernel.cpp TRT weights) places the
wall *exactly* half a link out: errors stay at the roundoff/steady-state
floor (max {trt_max:.1e}) at every resolution.

![convergence](validation_convergence.png)
"""
    (DOCS / "VALIDATION.md").write_text(md)
    print(f"wrote {DOCS / 'VALIDATION.md'} (TG order {tg_order:.2f}, "
          f"SRT Poiseuille order {po_order:.2f}, TRT max err {trt_max:.1e})")
    ok = tg_order > 1.5 and po_order > 1.5 and trt_max < 5e-4
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
