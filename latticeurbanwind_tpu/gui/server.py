"""LUW Studio server: deck editor + pipeline runner + results viewer.

Feature map to the reference Qt application (gui/src/):
  * project tree + schema-driven deck editor synced to canonical raw text
    (reference ConfigDocument.cpp / ConfigSchema.cpp — both read the same
    deck schema this framework defines in deck/schema.py)
  * pipeline orchestration with console forwarding and `[[LUW_PROGRESS]]`
    protocol parsing (reference CommandRunner.cpp:1-342)
  * result viewing: VTK slice renders + produced figures (reference
    VtkViewWidget.cpp; the streamcenter volume viewer maps to the
    layer-render endpoint here)
  * startup diagnostics (reference StartupDiagnostics.cpp) via /api/env

Implementation is stdlib-only (ThreadingHTTPServer); binds 127.0.0.1.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import threading
import time

import numpy as np
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

APP_HTML = Path(__file__).with_name("app.html")
PROGRESS_TAG = "[[LUW_PROGRESS]]"

# interactive renders decimate to this many cells: parsing + marching a
# production avg VTK (100M+ cells) per playback frame is what the
# reference's dedicated streamcenter viewer exists to avoid
# (streamcenter/ViewerWidget.cpp); a 2M-cell preview keeps frames sub-second
MAX_RENDER_CELLS = 2_000_000


class _VtkCache:
    """Parsed-VTK LRU keyed by (path, mtime_ns, size).

    Playback re-requests the same files once per slider tick; the parse of a
    multi-GB legacy binary VTK dominates the frame time, so cache the
    (meta, fields) tuples and invalidate on file change."""

    def __init__(self, capacity: int = 6):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: Dict = {}     # key -> (order, meta, fields)
        self._tick = 0

    def get(self, path: Path):
        from ..io.vtk import read_structured_points

        st = path.stat()
        key = (str(path), st.st_mtime_ns, st.st_size)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._tick += 1
                self._entries[key] = (self._tick, hit[1], hit[2])
                return hit[1], hit[2]
        meta, fields = read_structured_points(path)
        with self._lock:
            self._tick += 1
            self._entries[key] = (self._tick, meta, fields)
            stale = [k for k in self._entries if k[0] == str(path) and k != key]
            for k in stale:
                del self._entries[k]
            while len(self._entries) > self.capacity:
                oldest = min(self._entries, key=lambda k: self._entries[k][0])
                del self._entries[oldest]
        return meta, fields


def _decimate(arr: np.ndarray, in_plane_only: bool = False):
    """Stride-subsample a (Z,Y,X) or (3,Z,Y,X) field to <= MAX_RENDER_CELLS.

    Returns (array, stride).  `in_plane_only` keeps the z axis intact so
    slice indices stay valid."""
    spatial = arr.shape[-3:]
    cells = int(np.prod(spatial))
    if cells <= MAX_RENDER_CELLS:
        return arr, 1
    if in_plane_only:
        s = int(np.ceil(np.sqrt(spatial[1] * spatial[2]
                                / (MAX_RENDER_CELLS / spatial[0]))))
        sl = (..., slice(None), slice(None, None, s), slice(None, None, s))
    else:
        s = int(np.ceil((cells / MAX_RENDER_CELLS) ** (1.0 / 3.0)))
        sl = (..., slice(None, None, s), slice(None, None, s),
              slice(None, None, s))
    return arr[sl], s

# commands the Run panel may launch (mirrors cli/dispatch.py COMMANDS)
ALLOWED_COMMANDS = (
    "makeluw", "runluw", "luwbc", "luwcut", "luwvox", "luwval", "cdfinspect",
    "shpinspect", "cleanluw", "visluw", "vtk2nc", "luwcutvis", "luwspectra",
    "luwseason", "dgprepare", "buildingscale", "luwutmnc", "luwenv",
    "luwtkeviz", "visdem", "shptester", "luwdem", "luwvideo", "luwaij",
)


class Job:
    _next_id = 1
    _lock = threading.Lock()

    def __init__(self, argv: List[str], cwd: Path):
        with Job._lock:
            self.id = Job._next_id
            Job._next_id += 1
        self.argv = argv
        self.lines: List[str] = []
        self.progress: Optional[dict] = None
        self.rc: Optional[int] = None
        self.started = time.time()
        import os

        env = dict(os.environ, LUW_PROGRESS_MODE="gui",
                   PYTHONUNBUFFERED="1")
        self.proc = subprocess.Popen(
            argv, cwd=str(cwd), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, errors="replace")
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        assert self.proc.stdout is not None
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            if PROGRESS_TAG in line:
                try:
                    self.progress = json.loads(
                        line.split(PROGRESS_TAG, 1)[1].strip())
                except json.JSONDecodeError:
                    pass
                continue
            self.lines.append(line)
        self.rc = self.proc.wait()

    def state(self, start: int = 0) -> dict:
        return {
            "id": self.id, "argv": self.argv, "from": start,
            "lines": self.lines[start:], "n_lines": len(self.lines),
            "progress": self.progress, "done": self.rc is not None,
            "rc": self.rc, "elapsed": round(time.time() - self.started, 1),
        }


class Studio:
    def __init__(self, root: Path):
        from .stream import PyramidCache

        self.root = root.resolve()
        self.jobs: Dict[int, Job] = {}
        self.vtk_cache = _VtkCache()
        self.pyramids = PyramidCache()

    # ---------------- path safety ----------------
    def resolve(self, raw: str) -> Path:
        p = (self.root / raw).resolve() if not raw.startswith("/") else Path(raw).resolve()
        if p != self.root and self.root not in p.parents:
            raise PermissionError(f"path escapes studio root: {raw}")
        return p

    # ---------------- API handlers ----------------
    def api_tree(self, q) -> dict:
        sub = self.resolve(q.get("path", [""])[0])
        items = []
        if sub.is_dir():
            for child in sorted(sub.iterdir(),
                                key=lambda c: (c.is_file(), c.name.lower())):
                if child.name.startswith("."):
                    continue
                items.append({
                    "name": child.name,
                    "path": str(child.relative_to(self.root)),
                    "dir": child.is_dir(),
                    "size": child.stat().st_size if child.is_file() else 0,
                })
        return {"root": str(self.root), "path": str(sub.relative_to(self.root))
                if sub != self.root else "", "items": items}

    def api_schema(self, q) -> dict:
        from ..deck.schema import FIELDS, MODE_BITS, SECTIONS

        mode = q.get("mode", ["luw"])[0]
        bit = MODE_BITS.get(mode, 1)
        sections = []
        for s in SECTIONS:
            fields = [{
                "key": f.key, "kind": f.kind, "label": f.label or f.key,
                "help": f.help, "enum": list(f.enum_values),
            } for f in FIELDS if f.section == s.id and (f.modes & bit)]
            if fields:
                sections.append({"id": s.id, "title": s.title,
                                 "help": s.description, "fields": fields})
        return {"mode": mode, "sections": sections}

    def api_deck_get(self, q) -> dict:
        from ..deck import load_deck

        path = self.resolve(q["path"][0])
        deck = load_deck(path)
        return {
            "path": q["path"][0],
            "mode": path.suffix.lstrip("."),
            "raw": path.read_text(),
            "values": {k: str(v) for k, v in deck.to_dict().items()},
        }

    def api_deck_post(self, body: dict) -> dict:
        from ..deck import load_deck

        path = self.resolve(body["path"])
        if "raw" in body:
            path.write_text(body["raw"])
        deck = load_deck(path)
        for key, value in (body.get("values") or {}).items():
            deck.set_text(key, str(value))
        deck.save()
        return self.api_deck_get({"path": [body["path"]]})

    def api_run(self, body: dict) -> dict:
        cmd = body.get("cmd", "")
        if cmd not in ALLOWED_COMMANDS:
            raise ValueError(f"unknown command {cmd!r}")
        args = [str(a) for a in (body.get("args") or [])]
        cwd = self.resolve(body.get("cwd", ""))
        argv = [sys.executable, "-m", "latticeurbanwind_tpu.cli.dispatch",
                cmd, *args]
        job = Job(argv, cwd if cwd.is_dir() else cwd.parent)
        self.jobs[job.id] = job
        return job.state()

    def api_job(self, q) -> dict:
        job = self.jobs[int(q["id"][0])]
        return job.state(int(q.get("from", ["0"])[0]))

    def api_results(self, q) -> dict:
        base = self.resolve(q.get("path", [""])[0])
        out = {"vtks": [], "images": [], "csvs": []}
        for sub in ("RESULTS/vtk", "RESULTS", "RESULTS/sections",
                    "RESULTS/figures", "proj_temp", "proj_temp/snapshots",
                    "RESULTS/tke_viz", ""):
            d = base / sub if sub else base
            if not d.is_dir():
                continue
            for f in sorted(d.iterdir()):
                rel = str(f.relative_to(self.root))
                if f.suffix == ".vtk":
                    out["vtks"].append(rel)
                elif f.suffix in (".png", ".jpg"):
                    out["images"].append(rel)
                elif f.suffix == ".csv":
                    out["csvs"].append(rel)
        for k in out:
            out[k] = sorted(set(out[k]))
        return out

    def api_boundary(self, q) -> bytes:
        """SurfData boundary-CSV preview PNG — the BatchBoundaryPanel /
        BoundaryCsvPanel analog (reference gui/src/BatchBoundaryPanel.cpp,
        BoundaryCsvPanel.cpp): per-face sample scatter colored by |u|, with
        per-patch counts and speed statistics in the panel title."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from ..bc.samples import read_surfdata_csv

        path = self.resolve(q["path"][0])
        samples = read_surfdata_csv(path)   # native fast path + all variants
        x, y, z = samples.p.T
        speed = np.sqrt((samples.u ** 2).sum(axis=1))
        patch = (samples.patch if samples.patch is not None
                 else np.full(len(x), -1))

        fig, axes = plt.subplots(1, 3, figsize=(16, 5))
        sc = axes[0].scatter(x, y, c=speed, s=2, cmap="turbo")
        axes[0].set_title("plan view (X, Y)")
        axes[0].set_aspect("equal")
        fig.colorbar(sc, ax=axes[0], label="|u| (m/s)")
        sc1 = axes[1].scatter(x, z, c=speed, s=2, cmap="turbo")
        axes[1].set_title("elevation (X, Z)")
        fig.colorbar(sc1, ax=axes[1], label="|u| (m/s)")
        names = {0: "bottom", 1: "top", 2: "south", 3: "north",
                 4: "west", 5: "east", -1: "all", -999: "n/a"}
        stats = []
        for p in sorted(set(patch.tolist())):
            m = patch == p
            stats.append(f"{names.get(p, p)}: {int(m.sum())}")
            axes[2].scatter(x[m], z[m], s=2, label=names.get(p, str(p)))
        axes[2].set_title("faces (X, Z) by patch")
        axes[2].legend(markerscale=4, fontsize=8)
        fig.suptitle(f"{path.name} — {len(x)} samples, |u| "
                     f"{speed.min():.2f}..{speed.max():.2f} m/s | "
                     + ", ".join(stats))
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=100, bbox_inches="tight")
        plt.close(fig)
        return buf.getvalue()

    def api_series(self, q) -> dict:
        """Timestep series for a VTK: all files sharing its `<base>-<t>.vtk`
        stem, sorted by step — drives the playback slider (the streamcenter
        volume-streaming analog)."""
        import re

        path = self.resolve(q["path"][0])
        m = re.match(r"(.+)-(\d+)$", path.stem)
        if not m:
            return {"steps": [], "files": []}
        base = m.group(1)
        steps, files = [], []
        for f in sorted(path.parent.glob(f"{base}-*.vtk")):
            mm = re.match(r"(.+)-(\d+)$", f.stem)
            if mm and mm.group(1) == base:
                steps.append(int(mm.group(2)))
                files.append(str(f.relative_to(self.root)))
        order = sorted(range(len(steps)), key=lambda i: steps[i])
        return {"steps": [steps[i] for i in order],
                "files": [files[i] for i in order]}

    def api_render(self, q) -> bytes:
        """VTK render -> PNG (the VtkViewWidget/streamcenter analog).

        mode=slice (default): one z layer, quiver overlay for vectors.
        mode=mip: maximum-intensity projection along z/y/x.
        mode=3d: raytraced geometry + Q isosurface + streamlines through
        the orthographic camera (run/render.py; az/el/zoom parameters) —
        the analog of the reference's streamcenter 3-D volume viewer.
        mode=volume: VIS_FIELD volumetric raycast (graphics_field_rt) of
        |u| / rho / T (`color=`), opacity `gain=`, optional embedded
        colored slice plane `splane=z:12` (graphics_field_slice), all
        composited over the raytraced geometry.
        field=Q: virtual Q-criterion field derived from the velocity
        (run/snapshots.q_criterion, same stencil as the reference renderer).

        Parsed VTKs are served from an mtime-keyed LRU and fields above
        MAX_RENDER_CELLS are stride-decimated, so playback over production
        volumes stays interactive (the streamcenter design goal).
        """
        path = self.resolve(q["path"][0])
        meta, fields = self.vtk_cache.get(path)
        name = q.get("field", [None])[0]
        mode = q.get("mode", ["slice"])[0]
        axis = {"z": 0, "y": 1, "x": 2}.get(q.get("axis", ["z"])[0], 0)
        z = int(q.get("z", ["0"])[0])
        stride = 1
        if q.get("full", ["0"])[0] != "1":
            dec = {k: _decimate(v, in_plane_only=(mode == "slice"))
                   for k, v in fields.items()}
            stride = max((s for _, s in dec.values()), default=1)
            fields = {k: v for k, (v, _) in dec.items()}

        if mode in ("3d", "volume"):
            import tempfile

            from ..run.render import Camera, render_scene
            from ..run.snapshots import q_criterion

            vec = next((v for v in fields.values() if v.ndim == 4), None)
            fluid = fields.get("fluid")
            if fluid is not None:
                solid = fluid < 0.5
            elif vec is not None:
                solid = (np.abs(vec).sum(axis=0) == 0.0)
                solid[-1] = False      # open top even if still
            else:
                raise ValueError("3d view needs a vector or fluid field")
            qf = thr = None
            if (mode == "3d" and vec is not None
                    and q.get("q", ["1"])[0] != "0"):
                qf = q_criterion(vec.astype(np.float64)).astype(np.float32)
                qf[solid] = 0.0
                pos = qf[qf > 0]
                if pos.size:
                    thr = float(np.percentile(pos, 97.0))
            # VIS_FIELD volumetric overlay + embedded slice plane
            volume = slice_spec = None
            t_avg = 0.0
            if mode == "volume":
                cmode = q.get("color", ["u"])[0]
                scalar = None
                if cmode == "u" and vec is not None:
                    scalar = np.sqrt((vec.astype(np.float32) ** 2).sum(axis=0))
                elif cmode in ("rho", "T"):
                    key = next((k for k in fields
                                if k.split("_")[0].lower() == cmode.lower()
                                and fields[k].ndim == 3), None)
                    if key is None:
                        raise ValueError(f"no {cmode} field in this VTK")
                    scalar = fields[key].astype(np.float32)
                    if cmode == "T":
                        t_avg = float(scalar[~solid].mean()
                                      if (~solid).any() else scalar.mean())
                else:
                    raise ValueError("volume view needs a vector field "
                                     "(color=u) or a rho/T scalar")
                volume = (scalar, cmode)
                spl = q.get("splane", [""])[0]
                if spl:
                    ax_s, _, idx_s = spl.partition(":")
                    axis_n = {"z": 0, "y": 1, "x": 2}.get(ax_s, 0)
                    # the UI slider indexes the FULL-resolution grid; the
                    # fields above were already stride-decimated here, so
                    # rescale (render_scene only rescales when IT decimates)
                    slice_spec = (axis_n, int(idx_s or 0) // stride,
                                  scalar, cmode)
            cam = Camera(
                azimuth=float(q.get("az", ["225"])[0]),
                elevation=float(q.get("el", ["35"])[0]),
                zoom=float(q.get("zoom", ["1.0"])[0]),
                width=820, height=600)
            with tempfile.TemporaryDirectory() as td:
                out = render_scene(
                    solid, vec, Path(td) / "f.png", q=qf, q_threshold=thr,
                    cam=cam, title=path.name + (f" [decimated x{stride}]" if stride > 1 else ""),
                    streamlines=(mode == "3d"
                                 and q.get("sl", ["1"])[0] != "0"),
                    volume=volume, slice_spec=slice_spec, t_avg=t_avg,
                    opacity_gain=float(q.get("gain", ["1.0"])[0]))
                return out.read_bytes()

        if name == "Q":
            from ..run.snapshots import q_criterion

            vec = next((v for v in fields.values() if v.ndim == 4), None)
            if vec is None:
                raise ValueError("Q-criterion needs a vector field")
            arr = q_criterion(vec.astype(np.float64)).astype(np.float32)
            arr = np.clip(arr, 0.0, None)
        elif name is None or name not in fields:
            name = next(iter(fields))
            arr = fields[name]
        else:
            arr = fields[name]

        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        dtag = f" [decimated x{stride}]" if stride > 1 else ""
        fig, ax = plt.subplots(figsize=(7.2, 6))
        quiver = None
        if mode == "mip":
            mag = ((arr ** 2).sum(axis=0) ** 0.5) if arr.ndim == 4 else arr
            img = mag.max(axis=axis)
            im = ax.imshow(img, origin="lower",
                           cmap="inferno" if name == "Q" else "turbo")
            label = f"max |{name}| along {'zyx'[axis]}"
            title = f"{path.name} — {name} MIP/{'zyx'[axis]}{dtag}"
        elif arr.ndim == 4:       # vector slice: speed + quiver
            z = min(max(z, 0), arr.shape[1] - 1)
            sp = (arr[:, z] ** 2).sum(axis=0) ** 0.5
            im = ax.imshow(sp, origin="lower", cmap="turbo")
            st = max(1, max(sp.shape) // 24)
            quiver = (list(range(0, arr.shape[3], st)),
                      list(range(0, arr.shape[2], st)),
                      arr[0, z, ::st, ::st], arr[1, z, ::st, ::st])
            label = f"|{name}|"
            title = f"{path.name} — {name} @ z={z}{dtag}"
        else:
            z = min(max(z, 0), arr.shape[0] - 1)
            im = ax.imshow(arr[z], origin="lower",
                           cmap="inferno" if name == "Q" else "viridis")
            label = name
            title = f"{path.name} — {name} @ z={z}{dtag}"
        if quiver is not None:
            ax.quiver(*quiver, color="white", width=0.003)
        fig.colorbar(im, ax=ax, label=label)
        ax.set_title(title)
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=100, bbox_inches="tight")
        plt.close(fig)
        return buf.getvalue()

    # ------------- progressive volume streaming (streamcenter analog) ----
    def _pyramid(self, q):
        path = self.resolve(q["path"][0])
        field = q.get("field", ["u"])[0]
        st = path.stat()
        return self.pyramids.get(
            path, st, field, lambda: self.vtk_cache.get(path)[1])

    def api_volinfo(self, q) -> dict:
        """LOD/brick layout of one VTK field (gui/stream.py) — the client's
        entry point for progressive streaming (reference streamcenter
        ViewerWidget.cpp session/affinity setup analog)."""
        path = self.resolve(q["path"][0])
        meta, _ = self.vtk_cache.get(path)
        info = self._pyramid(q).info()
        info["spacing"] = meta.get("spacing")
        info["origin"] = meta.get("origin")
        return info

    def api_brick(self, q):
        """One raw float16 brick: body is little-endian float16, the
        X-Brick-Shape header carries its (dz,dy,dx).

        `path2` + `alpha` serve a temporally interpolated brick — the
        playback sub-frame source (reference FRUC frame interpolation,
        gui/src/NvidiaFrucRuntime.cpp:1-763).  Default interpolation is
        motion-compensated: per-brick phase-correlation displacement +
        advect-and-blend (gui/stream.warp_blend), which keeps advecting
        structures single and moving instead of cross-fade ghosting;
        `interp=lerp` requests the plain volume-space cross-fade."""
        coords = (int(q["level"][0]), int(q.get("i", ["0"])[0]),
                  int(q.get("j", ["0"])[0]), int(q.get("k", ["0"])[0]))
        pyr = self._pyramid(q)
        tile = pyr.brick(*coords)
        if "path2" in q:
            alpha = min(1.0, max(0.0, float(q.get("alpha", ["0.5"])[0])))
            q2 = dict(q)
            q2["path"] = q["path2"]
            pyr2 = self._pyramid(q2)
            t2 = pyr2.brick(*coords)
            if t2.shape != tile.shape:
                raise ValueError(
                    f"interpolation frames disagree on brick shape "
                    f"{tile.shape} vs {t2.shape} — different grids?")
            mode = q.get("interp", ["warp"])[0]
            if mode == "lerp":
                tile = ((1.0 - alpha) * tile.astype(np.float32)
                        + alpha * t2.astype(np.float32)).astype(np.float16)
            else:
                from .stream import warped_brick

                level = coords[0]
                tile = warped_brick(
                    pyr.levels[level], pyr2.levels[level], pyr.brick_size,
                    coords[1:], alpha).astype(np.float16)
        shape = ",".join(str(s) for s in tile.shape)
        return tile.tobytes(), {"X-Brick-Shape": shape}

    def api_vtk_info(self, q) -> dict:
        path = self.resolve(q["path"][0])
        meta, fields = self.vtk_cache.get(path)
        return {
            "fields": {k: list(v.shape) for k, v in fields.items()},
            "spacing": meta.get("spacing"), "origin": meta.get("origin"),
        }

    def api_pick(self, q) -> dict:
        """Cell picking (reference VtkViewWidget.cpp point-probe analog):
        given full-resolution grid indices — a column (axis + 2 in-plane
        indices) or one cell (z,y,x) — return world coordinates and every
        field's value there; columns also report the |column| profile and
        its argmax depth (what the stream viewer's MIP pixel shows)."""
        path = self.resolve(q["path"][0])
        meta, fields = self.vtk_cache.get(path)
        shape = next(iter(fields.values())).shape[-3:]
        sp = meta.get("spacing") or [1.0, 1.0, 1.0]
        org = meta.get("origin") or [0.0, 0.0, 0.0]

        def world(idx):   # (z,y,x) cell -> (x,y,z) world
            return [round(org[0] + idx[2] * sp[0], 3),
                    round(org[1] + idx[1] * sp[1], 3),
                    round(org[2] + idx[0] * sp[2], 3)]

        def values_at(idx):
            out = {}
            for name, arr in fields.items():
                v = arr[(...,) + tuple(idx)]
                if arr.ndim == 4:
                    out[name] = [round(float(c), 6) for c in v]
                    out[f"|{name}|"] = round(float(np.sqrt((v.astype(
                        np.float64) ** 2).sum())), 6)
                else:
                    out[name] = round(float(v), 6)
            return out

        if "z" in q and "y" in q and "x" in q:          # single cell
            idx = tuple(min(max(int(q[k][0]), 0), shape[i] - 1)
                        for i, k in enumerate(("z", "y", "x")))
            return {"cell": list(idx), "world": world(idx),
                    "values": values_at(idx)}

        axis = {"z": 0, "y": 1, "x": 2}[q.get("axis", ["z"])[0]]
        a = min(max(int(q.get("a", ["0"])[0]), 0),
                shape[1 if axis == 0 else 0] - 1)
        b = min(max(int(q.get("b", ["0"])[0]), 0),
                shape[2 if axis != 2 else 1] - 1)
        name = q.get("field", ["u"])[0]
        from .stream import select_scalar

        scalar = select_scalar(fields, name)
        col_idx = [slice(None)] * 3
        plane_axes = [i for i in range(3) if i != axis]
        col_idx[plane_axes[0]] = a
        col_idx[plane_axes[1]] = b
        col = scalar[tuple(col_idx)]
        k = int(np.argmax(col))
        idx = [0, 0, 0]
        idx[axis] = k
        idx[plane_axes[0]] = a
        idx[plane_axes[1]] = b
        stride = max(1, col.size // 256)
        return {
            "axis": q.get("axis", ["z"])[0], "cell": idx,
            "world": world(tuple(idx)),
            "argmax": k, "max": round(float(col[k]), 6),
            "profile": [round(float(v), 6) for v in col[::stride]],
            "profile_stride": stride,
            "values": values_at(tuple(idx)),
        }

    def api_spectra(self, q) -> bytes:
        """Wavenumber panel (reference gui/src/ wavenumber panel): per-layer
        horizontal kx-ky spectra of the VTK's velocity field on the
        ~every-50m layer ladder, shared log color scale, plus the radial
        E(k) with the k^-5/3 guide — rendered live from the cached parse."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from ..post.les_spectra import (
            horizontal_spectrum, layer_ladder, robust_log_limits, spectrum_3d,
        )

        path = self.resolve(q["path"][0])
        meta, fields = self.vtk_cache.get(path)
        vec = next((v for v in fields.values() if v.ndim == 4), None)
        if vec is None:
            raise ValueError("spectra need a vector field")
        vec, stride = _decimate(vec)
        sp = float(meta["spacing"][0]) * stride
        u = np.asarray(vec[0], np.float64)
        fluid = fields.get("fluid")
        if fluid is not None and stride > 1:
            fluid = fluid[::stride, ::stride, ::stride]
        dz = float(q.get("dz", ["50"])[0])
        ladder = layer_ladder(u.shape[0], sp, meta["origin"][2], dz)

        spectra = []
        for k, h in ladder[:9]:
            lay = u[k]
            valid = (fluid[k] > 0.5) if fluid is not None else (lay != 0)
            if float(valid.mean()) < 0.05:
                continue
            fill = lay[valid].mean() if valid.any() else 0.0
            kx, ky, E = horizontal_spectrum(np.where(valid, lay, fill), sp)
            spectra.append((h, kx, ky, E))
        if not spectra:
            raise ValueError("no layers with enough fluid cells")
        vmin, vmax = robust_log_limits([s[3] for s in spectra])

        n = len(spectra) + 1                      # +1 for the radial E(k)
        cols = min(3, n)
        rows = (n + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(4.6 * cols, 3.8 * rows),
                                 squeeze=False)
        for ax in axes.ravel():
            ax.set_axis_off()
        for ax, (h, kx, ky, E) in zip(axes.ravel(), spectra):
            ax.set_axis_on()
            pm = ax.pcolormesh(kx, ky, np.log10(np.maximum(E, 1e-300)),
                               vmin=vmin, vmax=vmax, shading="auto",
                               cmap="magma")
            ax.set_title(f"{h:.0f} m", fontsize=10)
        fig.colorbar(pm, ax=axes.ravel().tolist(), label="log10 E",
                     shrink=0.8)
        axr = axes.ravel()[len(spectra)]
        axr.set_axis_on()
        kc, Ek = spectrum_3d(u, sp)
        good = Ek > 0
        axr.loglog(kc[good], Ek[good], lw=1.2, label="E(k)")
        if good.any():
            kref = kc[good]
            axr.loglog(kref, Ek[good][0] * (kref / kref[0]) ** (-5.0 / 3.0),
                       "--", lw=0.9, label="k$^{-5/3}$")
        axr.set_xlabel("k (1/m)")
        axr.legend(fontsize=8)
        axr.set_title("radial E(k)", fontsize=10)
        fig.suptitle(f"{path.name} — horizontal spectra"
                     + (f" [decimated x{stride}]" if stride > 1 else ""))
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=100, bbox_inches="tight")
        plt.close(fig)
        return buf.getvalue()

    def api_buildingscale(self, q) -> bytes:
        """Building-scale panel (reference gui/src/ building panel): urban
        canopy morphology from the VTK's solid mask — built-height map,
        height histogram, and the lambda_p / lambda_f metrics
        (post/buildingscale.morphology_stats)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from ..post.buildingscale import morphology_stats

        path = self.resolve(q["path"][0])
        meta, fields = self.vtk_cache.get(path)
        fluid = fields.get("fluid")
        if fluid is not None:
            solid = np.asarray(fluid) < 0.5
        else:
            vec = next((v for v in fields.values() if v.ndim == 4), None)
            if vec is None:
                raise ValueError("building-scale needs a fluid or vector field")
            solid = np.abs(np.asarray(vec)).sum(axis=0) == 0.0
            solid[-1] = False
        solid, stride = _decimate(solid)
        cell = float(meta["spacing"][0]) * stride
        ground_k = max(1, int(q.get("ground", ["1"])[0]))
        stats = morphology_stats(solid, cell, ground_k)
        heights = solid[ground_k:].sum(axis=0) * cell

        fig, axes = plt.subplots(1, 3, figsize=(15, 4.6))
        im = axes[0].imshow(heights, origin="lower", cmap="cividis")
        axes[0].set_title("built height (m)")
        fig.colorbar(im, ax=axes[0], shrink=0.85)
        built = heights[heights > 0]
        if built.size:
            axes[1].hist(built, bins=min(30, max(5, int(built.max() / cell))),
                         color="#46627f")
        axes[1].set_xlabel("building height (m)")
        axes[1].set_ylabel("columns")
        axes[1].set_title(f"height histogram (mean "
                          f"{stats['mean_height_m']:.1f} m)")
        keys = ["lambda_p", "lambda_f_x", "lambda_f_y"]
        axes[2].bar(keys, [stats[k] for k in keys], color="#7f5a46")
        for i, k in enumerate(keys):
            axes[2].text(i, stats[k], f"{stats[k]:.3f}", ha="center",
                         va="bottom", fontsize=9)
        axes[2].set_title(f"canopy densities ({stats['built_columns']} "
                          "built columns)")
        fig.suptitle(f"{path.name} — urban morphology (cell {cell:.1f} m)"
                     + (f" [decimated x{stride}]" if stride > 1 else ""))
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=100, bbox_inches="tight")
        plt.close(fig)
        return buf.getvalue()

    def api_batch(self, q) -> dict:
        """Batch-boundary panel (reference gui/src/BatchBoundaryPanel.cpp):
        per-mode batch summary — the DG inflow x angle case matrix for
        .luwdg decks, the PF direction-case table (angle -> unit direction
        -> ANG_ prefix) plus wind-profile samples for .luwpf, and a mode
        summary for .luw."""
        from ..deck import load_deck
        from ..run.modes import _format_tag

        path = self.resolve(q["path"][0])
        deck = load_deck(path)
        mode = path.suffix.lstrip(".")
        out = {"mode": mode, "casename": deck.get_text("casename", "case")}
        if mode == "luwdg":
            inflows = deck.get_float_list("inflow")
            angles = deck.get_float_list("angle")
            out["inflows"] = inflows
            out["angles"] = angles
            out["matrix"] = [[f"DG_{_format_tag(u)}_{_format_tag(a)}_"
                              for a in angles] for u in inflows]
        elif mode == "luwpf":
            from ..bc.profile import direction_from_angle, load_profile_dat

            angles = deck.get_float_list("angle")
            cases = []
            for a in angles:
                dx, dy = direction_from_angle(a)
                cases.append({"angle": a, "dir_x": round(float(dx), 4),
                              "dir_y": round(float(dy), 4),
                              "case": f"ANG_{_format_tag(a)}_"
                              if len(angles) > 1 else "(single)"})
            out["cases"] = cases
            prof = path.parent / "wind_bc" / "profile.dat"
            if prof.exists():
                z, u = load_profile_dat(prof)
                out["profile"] = [[round(float(zz), 2), round(float(uu), 3)]
                                  for zz, uu in zip(z, u)]
            out["has_xls"] = bool(sorted(path.parent.glob("*.xls")))
        else:
            out["summary"] = {
                k: deck.get_text(k, "") for k in
                ("datetime", "run_nstep", "purge_avg", "n_gpu",
                 "gpu_memory", "unsteady_output", "frame_output")
                if deck.get_text(k, "")}
        return out

    def api_profileplot(self, q) -> bytes:
        """Profile preview PNG (reference ProfilePlotWidget): U(z) curve +
        sample markers from wind_bc/profile.dat next to the deck."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from ..bc.profile import load_profile_dat

        path = self.resolve(q["path"][0])
        prof = path.parent / "wind_bc" / "profile.dat"
        z, u = load_profile_dat(prof)
        fig, ax = plt.subplots(figsize=(5, 6))
        zz = np.linspace(z.min(), z.max(), 200)
        ax.plot(np.interp(zz, z, u), zz, lw=1.4, color="#46627f")
        ax.plot(u, z, "o", ms=4, color="#7f5a46", label="samples")
        ax.set_xlabel("U (m/s)")
        ax.set_ylabel("z AGL (m)")
        ax.set_title(f"{prof.parent.parent.name}/wind_bc/profile.dat")
        ax.grid(alpha=0.3)
        ax.legend()
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=100, bbox_inches="tight")
        plt.close(fig)
        return buf.getvalue()

    def api_aij(self, q) -> bytes:
        """Wind-tunnel validation panel (luwaij-backed): compare an executed
        .luwpf batch against the AIJ Case E dataset next to the deck and
        return the measured-vs-computed scatter figure."""
        from ..post.aij_casee import validate_deck

        path = self.resolve(q["path"][0])
        variant = q.get("variant", ["after"])[0]
        xls = sorted(path.parent.glob("*.xls"))
        if not xls:
            raise ValueError("no .xls dataset next to the deck")
        res = validate_deck(path, xls[0], variant=variant, make_figure=True)
        png = path.parent / "RESULTS" / f"aij_casee_{variant}.png"
        if not res["angles"] or not png.exists():
            raise ValueError("no ANG_*/avg VTKs found — run the deck first")
        return png.read_bytes()

    def api_env(self, q) -> dict:
        """Startup diagnostics (reference StartupDiagnostics.cpp).

        The device probe runs in a child process that allocates on demand
        and exits: the server itself never opens the accelerator, whose
        memory belongs to the solver jobs it launches."""
        info = {"python": sys.version.split()[0], "root": str(self.root)}
        import os

        env = dict(os.environ, XLA_PYTHON_CLIENT_PREALLOCATE="false")
        try:
            out = subprocess.run(
                [sys.executable, "-m", "latticeurbanwind_tpu.utils.accelerator"],
                env=env, capture_output=True, text=True, timeout=120,
                check=True)
            info.update(json.loads(out.stdout))
        except (subprocess.SubprocessError, ValueError) as e:
            info["jax_error"] = str(e)
        for mod in ("numpy", "scipy", "matplotlib", "pandas"):
            try:
                info[mod] = __import__(mod).__version__
            except ImportError:
                info[mod] = None
        return info


def make_handler(studio: Studio):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str, headers=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            u = urlparse(self.path)
            q = parse_qs(u.query)
            try:
                if u.path in ("/", "/index.html"):
                    self._send(200, APP_HTML.read_bytes(), "text/html")
                elif u.path == "/api/tree":
                    self._json(studio.api_tree(q))
                elif u.path == "/api/schema":
                    self._json(studio.api_schema(q))
                elif u.path == "/api/deck":
                    self._json(studio.api_deck_get(q))
                elif u.path == "/api/job":
                    self._json(studio.api_job(q))
                elif u.path == "/api/results":
                    self._json(studio.api_results(q))
                elif u.path == "/api/vtkinfo":
                    self._json(studio.api_vtk_info(q))
                elif u.path == "/api/pick":
                    self._json(studio.api_pick(q))
                elif u.path == "/api/volinfo":
                    self._json(studio.api_volinfo(q))
                elif u.path == "/api/brick":
                    body, hdrs = studio.api_brick(q)
                    self._send(200, body, "application/octet-stream", hdrs)
                elif u.path == "/api/render":
                    self._send(200, studio.api_render(q), "image/png")
                elif u.path == "/api/series":
                    self._json(studio.api_series(q))
                elif u.path == "/api/boundary":
                    self._send(200, studio.api_boundary(q), "image/png")
                elif u.path == "/api/spectra":
                    self._send(200, studio.api_spectra(q), "image/png")
                elif u.path == "/api/batch":
                    self._json(studio.api_batch(q))
                elif u.path == "/api/profileplot":
                    self._send(200, studio.api_profileplot(q), "image/png")
                elif u.path == "/api/buildingscale":
                    self._send(200, studio.api_buildingscale(q), "image/png")
                elif u.path == "/api/aij":
                    self._send(200, studio.api_aij(q), "image/png")
                elif u.path == "/api/env":
                    self._json(studio.api_env(q))
                elif u.path == "/api/file":
                    p = studio.resolve(q["path"][0])
                    ctype = {"png": "image/png", "csv": "text/plain",
                             "log": "text/plain"}.get(
                        p.suffix.lstrip("."), "application/octet-stream")
                    self._send(200, p.read_bytes(), ctype)
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:   # noqa: BLE001 — report to the UI
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

        def do_POST(self):
            u = urlparse(self.path)
            n = int(self.headers.get("Content-Length", "0"))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
                if u.path == "/api/deck":
                    self._json(studio.api_deck_post(body))
                elif u.path == "/api/run":
                    self._json(studio.api_run(body))
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:   # noqa: BLE001
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    return Handler


def serve(root: Path, port: int = 8750, host: str = "127.0.0.1"):
    studio = Studio(root)
    httpd = ThreadingHTTPServer((host, port), make_handler(studio))
    return httpd


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="luwstudio",
                                description="LUW Studio (local web UI)")
    p.add_argument("root", nargs="?", default=".",
                   help="project root (case directory or workspace)")
    p.add_argument("--port", type=int, default=8750)
    p.add_argument("--host", default="127.0.0.1")
    args = p.parse_args(list(sys.argv[1:] if argv is None else argv))
    root = Path(args.root).resolve()
    httpd = serve(root, args.port, args.host)
    print(f"LUW Studio: http://{args.host}:{httpd.server_address[1]}/  "
          f"(root: {root})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
