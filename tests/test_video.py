"""luwvideo: series frame export + field-space interpolation (reference
streamcenter recording, gui/streamcenter/ViewerWidget.cpp, and the FRUC
frame-interpolation analog, gui/src/NvidiaFrucRuntime.cpp)."""

from pathlib import Path

import numpy as np
import pytest

from latticeurbanwind_tpu.io.vtk import write_structured_points
from latticeurbanwind_tpu.post.video import (discover_series, export_frames,
                                             lerp_fields, main as video_main)


def _series(tmp_path, n_steps=3, mag0=1.0):
    Z, Y, X = 6, 10, 12
    files = []
    for i in range(n_steps):
        u = np.full((3, Z, Y, X), mag0 + i, np.float32)
        u[:, :, :, : X // 2] *= 0.5          # spatial structure
        f = tmp_path / f"demo_raw_u-{(i + 1) * 10:09d}.vtk"
        write_structured_points(f, {"u": u}, spacing=5.0)
        files.append(f)
    return files


def test_discover_series_sorts_by_step(tmp_path):
    files = _series(tmp_path)
    # an unrelated base must not join the series
    write_structured_points(tmp_path / "other_avg-000000005.vtk",
                            {"u": np.zeros((3, 2, 2, 2), np.float32)})
    got = discover_series(files[1])
    assert got == files
    assert discover_series(tmp_path / "noseries.vtk") == [
        tmp_path / "noseries.vtk"]


def test_lerp_fields_midpoint():
    fa = {"u": np.zeros((3, 2, 2, 2), np.float32)}
    fb = {"u": np.full((3, 2, 2, 2), 2.0, np.float32)}
    mid = lerp_fields(fa, fb, 0.5)
    assert np.allclose(mid["u"], 1.0)


def test_export_frames_with_interpolation(tmp_path):
    files = _series(tmp_path, n_steps=3)
    out_dir = tmp_path / "video"
    frames = export_frames(files[0], out_dir, mode="slice", z=2, interp=2)
    # 3 steps + 2 interpolated between each of the 2 gaps = 7 frames
    assert len(frames) == 7
    names = sorted(p.name for p in out_dir.glob("frame_*.png"))
    assert names == [f"frame_{i:05d}.png" for i in range(7)]
    assert all((out_dir / n).stat().st_size > 2000 for n in names)


def test_export_frames_3d_and_volume(tmp_path):
    files = _series(tmp_path, n_steps=2)
    for mode in ("3d", "volume"):
        frames = export_frames(files[0], tmp_path / f"v_{mode}", mode=mode)
        assert len(frames) == 2
        assert all(p.stat().st_size > 2000 for p in frames)


def test_video_cli(tmp_path):
    files = _series(tmp_path, n_steps=2)
    rc = video_main([str(files[0]), "--mode", "mip", "--interp", "1",
                     "--out-dir", str(tmp_path / "clip")])
    assert rc == 0
    assert len(list((tmp_path / "clip").glob("frame_*.png"))) == 3
    assert video_main([str(tmp_path / "missing.vtk")]) == 1


def test_video_via_dispatch(tmp_path):
    """The luwvideo command resolves through the CLI dispatch table (the
    same path the studio's export button and bin/luwvideo use)."""
    import subprocess
    import sys

    files = _series(tmp_path, n_steps=2)
    r = subprocess.run(
        [sys.executable, "-m", "latticeurbanwind_tpu.cli.dispatch",
         "luwvideo", files[0].name, "--mode", "slice"],
        cwd=tmp_path, capture_output=True, text=True,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": str(Path(__file__).resolve().parents[1])},
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ffmpeg" in r.stdout
    assert len(list((tmp_path / "video_demo_raw_u").glob("*.png"))) == 2
