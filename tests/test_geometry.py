"""STL I/O round-trips and voxelizer correctness on analytic solids."""

import numpy as np
import pytest

from latticeurbanwind_tpu.geometry import Mesh, read_stl, voxelize_mesh_columns, write_stl


def box_mesh(lo, hi):
    """Watertight axis-aligned box as 12 triangles."""
    lo = np.asarray(lo, dtype=np.float32)
    hi = np.asarray(hi, dtype=np.float32)
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]], dtype=np.float32)
    quads = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4), (2, 3, 7, 6), (1, 2, 6, 5), (3, 0, 4, 7)]
    tris = []
    for a, b, c, d in quads:
        tris.append([corners[a], corners[b], corners[c]])
        tris.append([corners[a], corners[c], corners[d]])
    return Mesh(tris=np.asarray(tris, dtype=np.float32))


def test_stl_round_trip(tmp_path):
    mesh = box_mesh((0, 0, 0), (2, 3, 4))
    path = tmp_path / "box.stl"
    write_stl(path, mesh)
    back = read_stl(path)
    assert back.tris.shape == mesh.tris.shape
    np.testing.assert_allclose(back.tris, mesh.tris, rtol=1e-6)
    np.testing.assert_allclose(back.pmin, [0, 0, 0])
    np.testing.assert_allclose(back.pmax, [2, 3, 4])


def test_read_reference_example_stl():
    from pathlib import Path

    mesh = read_stl(Path(__file__).resolve().parents[1] / "examples"
                    / "example_ProfileResearch_noDEM" / "proj_temp"
                    / "CityDemo_PF.stl")
    assert len(mesh.tris) > 100
    assert np.all(mesh.size > 0)


def test_voxelize_box():
    mesh = box_mesh((2, 3, 1), (10, 7, 5))
    solid = voxelize_mesh_columns(mesh, (8, 12, 16))
    # cell centers strictly inside [2,10]x[3,7]x[1,5]
    z, y, x = np.nonzero(solid)
    assert solid.sum() == (10 - 2) * (7 - 3) * (5 - 1)
    assert x.min() == 2 and x.max() == 9
    assert y.min() == 3 and y.max() == 6
    assert z.min() == 1 and z.max() == 4
    # nothing outside
    assert not solid[6].any()


def test_voxelize_two_towers():
    m1 = box_mesh((1, 1, 0), (4, 4, 6))
    m2 = box_mesh((8, 2, 0), (11, 5, 3))
    mesh = Mesh(tris=np.concatenate([m1.tris, m2.tris]))
    solid = voxelize_mesh_columns(mesh, (8, 8, 14))
    assert solid[2, 2, 2]       # inside tower 1
    assert solid[1, 3, 9]       # inside tower 2
    assert not solid[4, 3, 9]   # above tower 2 (height 3)
    assert not solid[0, 6, 6]   # between towers


def test_mesh_transforms():
    mesh = box_mesh((0, 0, 0), (2, 2, 2))
    rot = mesh.rotated_z(90.0, about=(0, 0, 0))
    np.testing.assert_allclose(rot.pmin, [-2, 0, 0], atol=1e-5)
    sc = mesh.scaled(2.0, about=(0, 0, 0))
    np.testing.assert_allclose(sc.pmax, [4, 4, 4], atol=1e-5)
    tr = mesh.translated((1, 2, 3))
    np.testing.assert_allclose(tr.pmin, [1, 2, 3], atol=1e-5)
