"""Offscreen solver snapshots — the framework's analog of the reference's
OpenCL graphics pipeline (reference: graphics.cpp + kernel.cpp:2574-3200,
invoked from run_lbm at setup.cpp:4843-4861 to write PNG frames).

Rather than a rasterizer/raytracer, snapshots are rendered from the live
device fields with matplotlib (Agg): velocity-magnitude slices with building
silhouettes, and the Q-criterion field (computed with the same
central-difference stencil as the reference's calculate_Q, kernel.cpp:933)
shown as a top-down maximum-intensity projection.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from ..lbm.state import LBMState, TYPE_S


def _render_on_device(arr) -> bool:
    """True when frames should render on the accelerator: the field is a
    JAX array living on a non-CPU device (or LUW_RENDER_DEVICE forces it).

    The reference renders all frames in-device (setup.cpp:4843-4861);
    the device path avoids pulling multi-GB u/flags to the host per frame
    — only the finished image leaves the chip (run/render_jax.py)."""
    import os

    force = os.environ.get("LUW_RENDER_DEVICE")
    if force is not None:
        return force == "1"
    try:
        import jax

        return (isinstance(arr, jax.Array)
                and next(iter(arr.devices())).platform != "cpu")
    except Exception:
        return False


def q_criterion(u: np.ndarray) -> np.ndarray:
    """Q = (||Omega||^2 - ||S||^2)/2 from central differences (lattice units).

    Matches the reference's cached formulation (kernel.cpp:933-955) including
    the extra 1/2 factor from the 2-cell-wide central difference.
    """
    def d(comp, axis):
        return 0.5 * (np.roll(comp, -1, axis) - np.roll(comp, 1, axis))

    # axes: u[c][z, y, x]; derivatives along x=2, y=1, z=0
    dudx, dudy, dudz = d(u[0], 2), d(u[0], 1), d(u[0], 0)
    dvdx, dvdy, dvdz = d(u[1], 2), d(u[1], 1), d(u[1], 0)
    dwdx, dwdy, dwdz = d(u[2], 2), d(u[2], 1), d(u[2], 0)
    omega2 = (dudy - dvdx) ** 2 + (dudz - dwdx) ** 2 + (dvdz - dwdy) ** 2
    s2 = (2.0 * (dudx ** 2 + dvdy ** 2 + dwdz ** 2)
          + (dudy + dvdx) ** 2 + (dudz + dwdx) ** 2 + (dvdz + dwdy) ** 2)
    return 0.25 * (omega2 - s2)


def write_snapshot(state: LBMState, out_path: Path, *, u_factor: float = 1.0,
                   nz_out: int = 0, title: str = "") -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    on_device = _render_on_device(state.u)
    if on_device:
        # panels computed on the accelerator; only slice/projection-sized
        # arrays are transferred (a production 100M-cell grid would
        # otherwise pull >1 GB to the host per snapshot)
        import jax.numpy as jnp

        u_j = jnp.asarray(state.u)
        flags_j = jnp.asarray(state.flags)
        if nz_out:
            u_j = u_j[:, :nz_out]
            flags_j = flags_j[:nz_out]
        Z, Y, X = flags_j.shape
        solid_j = (flags_j & TYPE_S) != 0
        speed_j = jnp.sqrt((u_j.astype(jnp.float32) ** 2).sum(axis=0))
        k = max(1, min(Z - 1, 2))
        jmid = Y // 2
        speed_k = np.asarray(speed_j[k]) * u_factor
        speed_y = np.asarray(speed_j[:, jmid, :]) * u_factor
        solid_k = np.asarray(solid_j[k])
        solid_y = np.asarray(solid_j[:, jmid, :])
    else:
        u = np.asarray(state.u) * u_factor
        flags = np.asarray(state.flags)
        if nz_out:
            u = u[:, :nz_out]
            flags = flags[:nz_out]
        Z, Y, X = flags.shape
        solid = (flags & TYPE_S) != 0
        speed = np.sqrt((u ** 2).sum(axis=0))
        k = max(1, min(Z - 1, 2))
        jmid = Y // 2
        speed_k, speed_y = speed[k], speed[:, jmid, :]
        solid_k, solid_y = solid[k], solid[:, jmid, :]

    fig, axes = plt.subplots(1, 3, figsize=(18, 5.5))
    pm0 = axes[0].pcolormesh(speed_k, shading="auto", cmap="viridis")
    axes[0].contourf(solid_k, levels=[0.5, 1.5], colors="k")
    axes[0].set_title(f"|u| @ z={k}")
    fig.colorbar(pm0, ax=axes[0], label="m/s")

    pm1 = axes[1].pcolormesh(speed_y, shading="auto", cmap="viridis")
    axes[1].contourf(solid_y, levels=[0.5, 1.5], colors="k")
    axes[1].set_title(f"|u| vertical slice @ y={jmid}")
    fig.colorbar(pm1, ax=axes[1], label="m/s")

    # Q panel from a decimated copy above 8M cells (the 18-roll f64 stencil
    # is minutes at 100M cells on host; the projection doesn't need full res)
    qs = 1
    if on_device:
        from .render_jax import q_criterion_device

        u_jq = jnp.asarray(state.u)
        solid_jq = (jnp.asarray(state.flags) & TYPE_S) != 0
        q_j = jnp.where(solid_jq, 0.0, q_criterion_device(u_jq))
        if q_j.size > 8_000_000:        # decimate ON DEVICE pre-download
            qs = int(np.ceil((q_j.size / 8_000_000) ** (1.0 / 3.0)))
            q_j = q_j[::qs, ::qs, ::qs]
            solid_jq = solid_jq[::qs, ::qs, ::qs]
        q = np.array(q_j)
        solid_full = np.asarray(solid_jq)
        uq = None
    if not on_device:
        uq = np.asarray(state.u)
        solid_full = (np.asarray(state.flags) & TYPE_S) != 0
        if solid_full.size > 8_000_000:
            qs = int(np.ceil((solid_full.size / 8_000_000) ** (1.0 / 3.0)))
            uq = uq[:, ::qs, ::qs, ::qs]
            solid_full = solid_full[::qs, ::qs, ::qs]
        q = q_criterion(uq)
        q[solid_full] = 0.0
    q_proj = q[: (nz_out // qs or None) if nz_out else Z].max(axis=0)
    vmax = max(np.percentile(q_proj, 99.5), 1e-12)
    pm2 = axes[2].pcolormesh(np.clip(q_proj, 0, vmax), shading="auto",
                             cmap="inferno")
    axes[2].set_title("Q-criterion (top-down max projection)")
    fig.colorbar(pm2, ax=axes[2], label="Q (lattice)")

    if title:
        fig.suptitle(title)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)

    # companion 3-D frame: raytraced flags + Q isosurface + streamlines
    # (reference raytrace/streamline kernels, kernel.cpp:2642-3200) —
    # rendered from the (possibly decimated) Q-grid arrays so shapes agree
    try:
        q_pos = q[~solid_full]
        thr = float(np.percentile(q_pos[q_pos > 0], 97.0)) if (q_pos > 0).any() else None
        out_3d = out_path.with_name(out_path.stem + "_3d.png")
        if on_device:
            # full-res march on the accelerator (no u download at all);
            # solid_j / u_j are already nz_out-trimmed above
            from .render_jax import render_scene_device

            render_scene_device(
                solid_j, u_j, out_3d,
                q=jnp.where(solid_j, 0.0, q_criterion_device(u_j))
                if thr is not None else None,
                q_threshold=thr, title=title, u_factor=1.0)
        else:
            from .render import render_scene

            nzq = (max(1, nz_out // qs) if nz_out else None)
            render_scene(
                solid_full[:nzq], uq[:, :nzq] * u_factor, out_3d,
                q=q[:nzq] if thr is not None else None,
                q_threshold=thr, title=title, u_factor=1.0)
    except Exception as e:   # rendering must never kill a solver run
        print(f"[snapshots] 3-D render skipped: {e}")
    return out_path


def write_frame(state: LBMState, out_path: Path, *, nz_out: int = 0,
                title: str = "", fov: float = 70.0) -> Path:
    """One perspective video frame (no VTK dump): raytraced geometry +
    Q isosurface + streamlines through the pinhole camera.

    The deck's `frame_output` stride drives these — the analog of the
    reference's per-event PNG frame writes (setup.cpp:4843-4861, in-device
    graphics kernels) — with zero-padded numbering so the set is
    ffmpeg-ready (`ffmpeg -pattern_type glob -i 'frames/*.png' ...`)."""
    from .render import Camera, render_scene

    if _render_on_device(state.u):
        import jax.numpy as jnp

        from .render_jax import q_criterion_device, render_scene_device

        u_j = jnp.asarray(state.u)
        flags_j = jnp.asarray(state.flags)
        if nz_out:
            u_j = u_j[:, :nz_out]
            flags_j = flags_j[:nz_out]
        solid_j = (flags_j & TYPE_S) != 0
        q_j = jnp.where(solid_j, 0.0, q_criterion_device(u_j))
        frac = float((q_j > 0).mean())
        thr = None
        if frac > 0:
            # 97th percentile of the positive part == (1 - 0.03*frac)
            # quantile of the full field (device-friendly formulation)
            thr = float(jnp.percentile(q_j.reshape(-1),
                                       100.0 * (1.0 - 0.03 * frac)))
        return render_scene_device(
            solid_j, u_j, out_path, q=q_j if thr is not None else None,
            q_threshold=thr, cam=Camera(fov=fov), title=title)

    u = np.asarray(state.u)
    flags = np.asarray(state.flags)
    if nz_out:
        u = u[:, :nz_out]
        flags = flags[:nz_out]
    # decimate BEFORE the Q stencil: q_criterion is 18 full-grid rolls in
    # f64 — minutes per frame at 100M cells, while the frame itself renders
    # from <= 8M cells anyway (render_scene would re-decimate)
    cells = int(np.prod(flags.shape))
    if cells > 8_000_000:
        s = int(np.ceil((cells / 8_000_000) ** (1.0 / 3.0)))
        u = u[:, ::s, ::s, ::s]
        flags = flags[::s, ::s, ::s]
    solid = (flags & TYPE_S) != 0
    q = q_criterion(u)
    q[solid] = 0.0
    q_pos = q[q > 0]
    thr = float(np.percentile(q_pos, 97.0)) if q_pos.size else None
    return render_scene(
        solid, u, out_path, q=q if thr is not None else None,
        q_threshold=thr, cam=Camera(fov=fov), title=title)


def _decode_ddf_np(raw: np.ndarray) -> np.ndarray:
    """Stored DDFs -> fp32, inferring the storage codec from the dtype
    (f32/bf16 pass through, float16 is the FP16S range shift, uint16 is
    the FP16C software format — lbm/state.py codecs)."""
    if raw.dtype == np.uint16:            # FP16C value-space codec
        import jax.numpy as jnp

        from ..lbm.state import decode_fp16c

        return np.asarray(decode_fp16c(jnp.asarray(raw)))
    f = raw.astype(np.float32)
    if raw.dtype == np.float16:           # FP16S-style range shift
        f = f * (1.0 / 32768.0)
    return f


def solid_boundary_force_field(state: LBMState) -> np.ndarray:
    """Per-cell momentum-exchange force on solid cells, (3, Z, Y, X) in
    lattice units — the reference's FORCE_FIELD extension
    (update_force_field, kernel.cpp:2031-2130): every fluid-solid link
    deposits the halfway-bounce-back transfer 2 c_i (f_i + w_i) onto the
    solid cell, giving the colored per-boundary force the flags renderer
    draws (kernel.cpp:2698-2709) and per-object force sums."""
    from ..lbm.lattice import C19, W19

    solid = (np.asarray(state.flags) & TYPE_S) != 0
    f = _decode_ddf_np(np.asarray(state.fi))
    F = np.zeros((3, *solid.shape), np.float64)
    for d in range(1, 19):
        cx, cy, cz = (int(v) for v in C19[d])
        # fluid cell at x with solid neighbor at x + c_d: the post-collision
        # population f_d heads into the wall and bounces, depositing 2 c_d f_d
        nbr_solid = np.roll(solid, shift=(-cz, -cy, -cx), axis=(0, 1, 2))
        link = (~solid) & nbr_solid
        if not link.any():
            continue
        mom = np.where(link, f[d] + float(W19[d]), 0.0)   # undo the DDF shift
        # scatter onto the receiving solid cell at x + c_d
        onto = np.roll(mom, shift=(cz, cy, cx), axis=(0, 1, 2))
        for c, comp in enumerate((cx, cy, cz)):
            if comp:
                F[c] += 2.0 * comp * onto
    F[:, ~solid] = 0.0
    return F


def solid_boundary_force(state: LBMState) -> np.ndarray:
    """Total momentum-exchange force on solid cells, (3,) lattice units.

    Same physics as solid_boundary_force_field but accumulated as scalars
    per direction — the field variant materializes a (3, Z, Y, X) float64
    array (+ per-direction roll temporaries), multi-GB at production grids,
    which a caller wanting only the total must not pay."""
    from ..lbm.lattice import C19, W19

    solid = (np.asarray(state.flags) & TYPE_S) != 0
    f = _decode_ddf_np(np.asarray(state.fi))
    total = np.zeros(3, np.float64)
    for d in range(1, 19):
        cx, cy, cz = (int(v) for v in C19[d])
        nbr_solid = np.roll(solid, shift=(-cz, -cy, -cx), axis=(0, 1, 2))
        link = (~solid) & nbr_solid
        if not link.any():
            continue
        # total over links; the scatter roll in the field variant conserves
        # the sum, so it drops out of the total (accumulate in f64 like it)
        s = 2.0 * float((f[d][link] + float(W19[d])).sum(dtype=np.float64))
        for c, comp in enumerate((cx, cy, cz)):
            if comp:
                total[c] += comp * s
    return total
