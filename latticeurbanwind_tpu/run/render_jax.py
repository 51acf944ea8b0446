"""On-device frame rendering: the jitted JAX twin of run/render.py.

The reference renders every snapshot frame in-device (graphics kernels,
kernel.cpp:2642-3200, invoked per event from setup.cpp:4843-4861) — the
host only ever sees the finished bitmap.  The numpy renderer in
run/render.py instead needs u + flags on the host, which at production
grid sizes means a multi-GB device->host transfer per frame.

This module keeps the whole march on the accelerator: one jitted
ray-march over a label grid (0 empty / 1 solid / 2 Q-isosurface) fused
with the VIS_FIELD volumetric accumulation (same weighted-mean semantics
as fieldvis.raycast_field / reference ray_grid_traverse_sum,
kernel.cpp:2786-2862), followed by device-side Lambert shading and
streamline integration.  Only the (H, W, 3) image, the depth buffer, and
the streamline polylines (a few hundred KB) are pulled to the host, where
matplotlib composes the PNG.

Pure jnp — runs identically on CPU for tests; the algorithm matches the
numpy marcher (same step length, same shading model), so images agree to
sampling jitter.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .render import Camera, _camera_rays

STEP = 0.7                       # cells per march step (render._march)


def _box_blur(occ: jnp.ndarray) -> jnp.ndarray:
    """3-wide box blur along every axis (render._smooth_occupancy)."""
    for axis in range(3):
        occ = (jnp.roll(occ, 1, axis) + occ + jnp.roll(occ, -1, axis)) / 3.0
    return occ


@partial(jax.jit, static_argnames=("n_steps", "with_field"))
def _march_trace(label: jnp.ndarray, scalar: jnp.ndarray,
                 origins: jnp.ndarray, dirs: jnp.ndarray,
                 w_half: jnp.ndarray, *, n_steps: int, with_field: bool):
    """Lock-step first-hit march + volumetric accumulation.

    label: (Z, Y, X) int8 — 0 empty, >0 opaque layer id (first hit wins).
    scalar: (Z, Y, X) f32 field samples for the volume overlay (|u| etc.).
    w_half: scalar f32 — the velocity-mode weight pivot 0.5/scale
      (kernel.cpp:2815: weight = min(v, |v - 0.5/scale|)).
    Returns (hit_label (N,) int8, t_hit (N,) f32, hit_pos (N, 3) f32,
             wsum (N,), vsum (N,), steps_in (N,)).
    """
    Z, Y, X = label.shape
    n = origins.shape[0]
    per_ray = dirs.ndim == 2
    dv = dirs if per_ray else jnp.broadcast_to(dirs, (n, 3))
    dims = jnp.array([X, Y, Z], jnp.float32)
    inv = jnp.where(jnp.abs(dv) > 1e-12, 1.0 / dv, jnp.inf)
    t0 = (0.0 - origins) * inv
    t1 = (dims[None, :] - 1.0 - origins) * inv
    t_lo = jnp.maximum(jnp.minimum(t0, t1).max(axis=1), 0.0)
    t_hi = jnp.maximum(t0, t1).min(axis=1)

    flat = label.reshape(-1)
    sflat = scalar.reshape(-1)
    cap = jnp.array([X - 1, Y - 1, Z - 1])

    def body(state):
        i, t, active, hit_label, t_hit, hit_pos, wsum, vsum, steps_in = state
        pos = origins + t[:, None] * dv
        ijk = jnp.clip(jnp.round(pos).astype(jnp.int32), 0, cap[None, :])
        lin = (ijk[:, 2] * Y + ijk[:, 1]) * X + ijk[:, 0]
        lab = flat[lin]
        newly = active & (lab > 0)
        hit_label = jnp.where(newly, lab, hit_label)
        t_hit = jnp.where(newly, t, t_hit)
        hit_pos = jnp.where(newly[:, None], pos, hit_pos)
        if with_field:
            v = sflat[lin]
            w = jnp.where(active & (lab == 0),
                          jnp.minimum(v, jnp.abs(v - w_half)), 0.0)
            wsum = wsum + w
            vsum = vsum + w * v
            steps_in = steps_in + (active & (lab == 0))
        active = active & ~newly & (t + STEP <= t_hi)
        return (i + 1, t + STEP, active, hit_label, t_hit, hit_pos,
                wsum, vsum, steps_in)

    def cond(state):
        i, _, active, *_ = state
        return (i < n_steps) & jnp.any(active)

    init = (jnp.int32(0), t_lo, t_hi > t_lo,
            jnp.zeros(n, jnp.int8), jnp.full(n, jnp.inf, jnp.float32),
            jnp.zeros((n, 3), jnp.float32), jnp.zeros(n, jnp.float32),
            jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.int32))
    _, _, _, hit_label, t_hit, hit_pos, wsum, vsum, steps_in = (
        jax.lax.while_loop(cond, body, init))
    return hit_label, t_hit, hit_pos, wsum, vsum, steps_in


@jax.jit
def _shade_hits(occ: jnp.ndarray, hit_pos: jnp.ndarray, t_hit: jnp.ndarray,
                base_rgb: jnp.ndarray, hit_label: jnp.ndarray,
                diag: jnp.ndarray) -> jnp.ndarray:
    """Lambert + depth fog at hit points (render._shade, same constants)."""
    Z, Y, X = occ.shape
    flat = occ.reshape(-1)
    p = jnp.clip(jnp.round(hit_pos).astype(jnp.int32), 1,
                 jnp.array([X - 2, Y - 2, Z - 2])[None, :])

    def at(dx, dy, dz):
        lin = ((p[:, 2] + dz) * Y + (p[:, 1] + dy)) * X + (p[:, 0] + dx)
        return flat[lin]

    g = jnp.stack([at(1, 0, 0) - at(-1, 0, 0),
                   at(0, 1, 0) - at(0, -1, 0),
                   at(0, 0, 1) - at(0, 0, -1)], axis=1)
    nrm = -g / jnp.maximum(jnp.linalg.norm(g, axis=1, keepdims=True), 1e-6)
    light = jnp.array([0.5, -0.3, 0.8])
    light = light / jnp.linalg.norm(light)
    lam = jnp.clip(nrm @ light, 0.0, 1.0) * 0.75 + 0.25
    fog = jnp.clip(1.0 - 0.25 * (t_hit / (2.0 * diag)), 0.0, 1.0)
    rgb = base_rgb[jnp.clip(hit_label.astype(jnp.int32), 0,
                            base_rgb.shape[0] - 1)]
    return rgb * (lam * fog)[:, None]


@partial(jax.jit, static_argnames=("n_steps",))
def _streamlines_device(u: jnp.ndarray, seeds: jnp.ndarray,
                        solid: jnp.ndarray, *, n_steps: int = 250,
                        dt: float = 0.8):
    """Midpoint-RK2 streamline integration on device
    (render.integrate_streamlines, reference kernel.cpp:2952-3007)."""
    Z, Y, X = solid.shape
    dims = jnp.array([X, Y, Z], jnp.float32)
    cap = jnp.array([X - 1, Y - 1, Z - 1])
    uf = u.reshape(3, -1)
    sflat = solid.reshape(-1)

    def vel_at(p):
        ijk = jnp.clip(jnp.round(p).astype(jnp.int32), 0, cap[None, :])
        lin = (ijk[:, 2] * Y + ijk[:, 1]) * X + ijk[:, 0]
        return uf[:, lin].T, sflat[lin]

    def body(carry, _):
        p, alive = carry
        v1, _ = vel_at(p)
        sp = jnp.linalg.norm(v1, axis=1, keepdims=True)
        v2, _ = vel_at(p + 0.5 * v1 / jnp.maximum(sp, 1e-9) * dt)
        sp2 = jnp.linalg.norm(v2, axis=1, keepdims=True)
        p_new = p + v2 / jnp.maximum(sp2, 1e-9) * dt
        inside = ((p_new >= 0) & (p_new <= dims[None, :] - 1)).all(axis=1)
        _, in_solid = vel_at(p_new)
        alive = alive & inside & ~in_solid & (sp[:, 0] > 1e-9)
        p = jnp.where(alive[:, None], p_new, p)
        spd = jnp.linalg.norm(vel_at(p)[0], axis=1)
        rec = jnp.where(alive[:, None], p, jnp.nan)
        return (p, alive), (rec, jnp.where(alive, spd, jnp.nan))

    p0 = seeds.astype(jnp.float32)
    sp0 = jnp.linalg.norm(vel_at(p0)[0], axis=1)
    (_, _), (path_tail, speed_tail) = jax.lax.scan(
        body, (p0, jnp.ones(seeds.shape[0], bool)), None, length=n_steps)
    paths = jnp.concatenate([p0[None], path_tail], axis=0)
    speeds = jnp.concatenate([sp0[None], speed_tail], axis=0)
    return paths, speeds


def render_scene_device(solid, u, out_path: Path, *,
                        q=None, q_threshold: Optional[float] = None,
                        cam: Optional[Camera] = None, title: str = "",
                        streamlines: bool = True, u_factor: float = 1.0,
                        volume_mode: bool = False,
                        field_scale: Optional[float] = None,
                        opacity_gain: float = 1.0) -> Path:
    """render_scene twin that keeps flags/u/q on the accelerator.

    solid: (Z, Y, X) bool jax array; u: (3, Z, Y, X) or None; q: optional
    precomputed Q field.  `volume_mode=True` adds the VIS_FIELD |u|
    volumetric haze (graphics_field_rt analog) in the same march.
    No decimation: device memory traffic is a handful of passes over the
    grid, and only the image leaves the chip.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    cam = cam or Camera()
    solid = jnp.asarray(solid)
    shape = tuple(solid.shape)
    Z, Y, X = shape
    diag = float(np.linalg.norm([X, Y, Z]))

    label = solid.astype(jnp.int8)
    if q is not None and q_threshold is not None:
        label = jnp.where((jnp.asarray(q) > q_threshold) & ~solid,
                          jnp.int8(2), label)
    occ = _box_blur((label > 0).astype(jnp.float32))

    speed = None
    scalar = jnp.zeros(shape, jnp.float32)
    w_half = jnp.float32(0.0)
    if volume_mode and u is not None:
        speed = jnp.sqrt((jnp.asarray(u).astype(jnp.float32) ** 2).sum(0))
        scalar = speed
        if field_scale is None:
            top = float(jnp.percentile(speed.reshape(-1), 99.5))
            field_scale = 1.0 / max(top, 1e-9)
        w_half = jnp.float32(0.5 / field_scale)

    origins, dirs, _ = _camera_rays(shape, cam)
    n_steps = int(np.ceil(2.0 * diag / STEP)) + 2
    hit_label, t_hit, hit_pos, wsum, vsum, steps_in = _march_trace(
        label, scalar, jnp.asarray(origins), jnp.asarray(dirs), w_half,
        n_steps=n_steps, with_field=bool(volume_mode and u is not None))

    base_rgb = jnp.array([[1.0, 1.0, 1.0],        # 0: background
                          [0.55, 0.55, 0.6],      # 1: solid
                          [0.85, 0.3, 0.15]])     # 2: Q isosurface
    shaded = _shade_hits(occ, hit_pos, t_hit, base_rgb, hit_label,
                         jnp.float32(diag))
    hitm = hit_label > 0
    img = jnp.where(hitm[:, None], shaded, jnp.ones((1, 3)))
    if volume_mode and u is not None:
        mean = jnp.where(wsum > 0, vsum / jnp.maximum(wsum, 1e-12), 0.0)
        from .fieldvis import colorscale_rainbow
        rgb_v = jnp.asarray(colorscale_rainbow(
            np.asarray(field_scale * mean, np.float32)))
        alpha = jnp.clip((wsum * 2.0 * field_scale * opacity_gain - 1.0)
                         / jnp.maximum(steps_in, 1), 0.0, 1.0)
        img = rgb_v * alpha[:, None] + img * (1.0 - alpha[:, None])

    # ---- host composition (image-sized data only) ----
    img_np = np.asarray(img).reshape(cam.height, cam.width, 3)
    depth_np = np.asarray(t_hit).reshape(cam.height, cam.width)

    fig, ax = plt.subplots(figsize=(cam.width / 100, cam.height / 100))
    ax.imshow(np.clip(img_np, 0, 1))
    if streamlines and u is not None:
        from .render import default_seeds, project_points

        seeds = default_seeds(shape, None)
        if len(seeds):
            paths_j, speeds_j = _streamlines_device(
                jnp.asarray(u).astype(jnp.float32), jnp.asarray(seeds),
                solid, n_steps=250)
            paths = np.asarray(paths_j)
            speeds = np.asarray(speeds_j)
            col, row, t = project_points(paths.reshape(-1, 3), shape, cam)
            col = col.reshape(paths.shape[:2])
            row = row.reshape(paths.shape[:2])
            t = t.reshape(paths.shape[:2])
            vmax = np.nanmax(speeds) * u_factor + 1e-12
            cmap = plt.get_cmap("turbo")
            segs, colors = [], []
            for s in range(paths.shape[1]):
                c, r, tt, sp = col[:, s], row[:, s], t[:, s], speeds[:, s]
                ok = np.isfinite(c) & np.isfinite(r)
                ci = np.clip(np.nan_to_num(c).astype(np.int64), 0,
                             cam.width - 1)
                ri = np.clip(np.nan_to_num(r).astype(np.int64), 0,
                             cam.height - 1)
                vis = ok & (tt <= depth_np[ri, ci] + 1.0)
                pts = np.stack([c, r], axis=1)
                for k in range(len(pts) - 1):
                    if vis[k] and vis[k + 1]:
                        segs.append([pts[k], pts[k + 1]])
                        colors.append(cmap(min(sp[k] * u_factor / vmax, 1.0)))
            if segs:
                ax.add_collection(LineCollection(segs, colors=colors,
                                                 linewidths=1.0))
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


def q_criterion_device(u) -> jnp.ndarray:
    """Q-criterion on device (snapshots.q_criterion, kernel.cpp:933-955)."""
    u = jnp.asarray(u).astype(jnp.float32)

    def d(comp, axis):
        return 0.5 * (jnp.roll(comp, -1, axis) - jnp.roll(comp, 1, axis))

    dudx, dudy, dudz = d(u[0], 2), d(u[0], 1), d(u[0], 0)
    dvdx, dvdy, dvdz = d(u[1], 2), d(u[1], 1), d(u[1], 0)
    dwdx, dwdy, dwdz = d(u[2], 2), d(u[2], 1), d(u[2], 0)
    omega2 = (dudy - dvdx) ** 2 + (dudz - dwdx) ** 2 + (dvdz - dwdy) ** 2
    s2 = (2.0 * (dudx ** 2 + dvdy ** 2 + dwdz ** 2)
          + (dudy + dvdx) ** 2 + (dudz + dwdx) ** 2 + (dvdz + dwdy) ** 2)
    return 0.25 * (omega2 - s2)
