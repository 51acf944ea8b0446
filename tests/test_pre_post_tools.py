"""Preprocessing + postprocessing tools: UTM math, terrain interpolation,
CLI pipeline stages, NetCDF export."""

import numpy as np
import pytest

from latticeurbanwind_tpu.pre.terrain import (
    TerrainConfig, idw_interpolate, interpolate_terrain_grid, kriging_interpolate,
)
from latticeurbanwind_tpu.pre.utm import (
    lonlat_to_utm, utm_epsg_for, utm_to_lonlat, utm_zone_for,
)


def test_utm_zone_and_epsg():
    assert utm_zone_for(121.5) == 51
    assert utm_epsg_for(121.5, 31.2) == 32651
    assert utm_epsg_for(121.5, -31.2) == 32751
    assert utm_zone_for(-74.0) == 18


def test_utm_known_point():
    # Published reference: (lon 121.5, lat 31.25) -> UTM 51N
    e, n = lonlat_to_utm(np.array([121.5]), np.array([31.25]))
    # zone 51 central meridian 123E; computed with independent tooling
    assert 350000 < e[0] < 370000
    assert 3455000 < n[0] < 3465000
    # round trip to sub-millimeter
    lon, lat = utm_to_lonlat(e, n, zone=51)
    assert abs(lon[0] - 121.5) < 1e-8
    assert abs(lat[0] - 31.25) < 1e-8


def test_utm_round_trip_grid():
    lon = np.linspace(120.5, 122.5, 7)
    lat = np.linspace(30.0, 32.0, 7)
    glon, glat = np.meshgrid(lon, lat)
    e, n = lonlat_to_utm(glon.ravel(), glat.ravel(), zone=51)
    lon2, lat2 = utm_to_lonlat(e, n, zone=51)
    np.testing.assert_allclose(lon2, glon.ravel(), atol=1e-8)
    np.testing.assert_allclose(lat2, glat.ravel(), atol=1e-8)


def test_idw_and_kriging_reproduce_plane():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1000, (300, 2))
    z = 5.0 + 0.01 * pts[:, 0] + 0.02 * pts[:, 1]
    targets = rng.uniform(100, 900, (50, 2))
    expect = 5.0 + 0.01 * targets[:, 0] + 0.02 * targets[:, 1]
    got_idw = idw_interpolate(pts, z, targets, neighbors=12)
    np.testing.assert_allclose(got_idw, expect, atol=0.8)
    got_k = kriging_interpolate(pts, z, targets, neighbors=12, use_jax=False)
    np.testing.assert_allclose(got_k, expect, atol=0.25)
    # kriging should beat IDW on a linear trend
    assert np.abs(got_k - expect).mean() <= np.abs(got_idw - expect).mean() + 1e-6


def test_terrain_grid_exact_at_samples():
    pts = np.array([[0.0, 0.0], [100.0, 0.0], [0.0, 100.0], [100.0, 100.0],
                    [50.0, 50.0]])
    z = np.array([10.0, 20.0, 30.0, 40.0, 25.0])
    cfg = TerrainConfig(approach="idw", grid_resolution=50, idw_sigma=0.0,
                        neighbors=4)
    grid = interpolate_terrain_grid(pts, z, np.array([0.0, 50.0, 100.0]),
                                    np.array([0.0, 50.0, 100.0]), cfg)
    assert grid.shape == (3, 3)
    assert grid[0, 0] == pytest.approx(10.0, abs=1e-6)
    assert grid[2, 2] == pytest.approx(40.0, abs=1e-6)
    assert grid[1, 1] == pytest.approx(25.0, abs=1e-6)


def test_transform_model_round_trip():
    from latticeurbanwind_tpu.deck import parse_deck_text
    from latticeurbanwind_tpu.post.transform import TransformModel

    deck = parse_deck_text("""
    cut_lon_manual = [121.3, 121.7]
    cut_lat_manual = [31.1, 31.4]
    utm_crs = "EPSG:32651"
    rotate_deg = 12.5
    """)
    model = TransformModel.from_deck(deck, (30000.0, 25000.0))
    x = np.array([1000.0, 15000.0, 29000.0])
    y = np.array([2000.0, 12500.0, 24000.0])
    lon, lat = model.local_to_lonlat(x, y)
    x2, y2 = model.lonlat_to_local(lon, lat)
    np.testing.assert_allclose(x2, x, atol=1e-4)
    np.testing.assert_allclose(y2, y, atol=1e-4)
    # derotation preserves speed
    ue, vn = model.derotate_winds(np.array([3.0]), np.array([4.0]))
    assert np.hypot(ue, vn)[0] == pytest.approx(5.0, rel=1e-6)


def test_prerun_validation_pass_and_fail(tmp_path):
    from latticeurbanwind_tpu.cli.validate import main as luwval
    from latticeurbanwind_tpu.deck import load_deck
    from latticeurbanwind_tpu.geometry import write_stl
    from tests.test_geometry import box_mesh

    case = tmp_path / "case"
    (case / "proj_temp").mkdir(parents=True)
    (case / "conf.luw").write_text(
        "casename = t\ndatetime = 20250101000000\n"
        "cut_lon_manual = [1,2]\ncut_lat_manual = [3,4]\n")
    write_stl(case / "proj_temp" / "t.stl", box_mesh((0, 0, 0), (1000, 800, 100)))
    csv = case / "proj_temp" / "SurfData_20250101000000.csv"
    csv.write_text("X,Y,Z,u,v,w\n0,0,10,1,0,0\n1000,800,10,1,0,0\n")
    assert luwval([str(case / "conf.luw")]) == 0
    deck = load_deck(case / "conf.luw")
    assert deck.get_text("validation") == "pass"
    assert deck.get_int("gpu_memory") is not None
    # now break the extents
    csv.write_text("X,Y,Z,u,v,w\n0,0,10,1,0,0\n1500,800,10,1,0,0\n")
    luwval([str(case / "conf.luw")])
    assert load_deck(case / "conf.luw").get_text("validation") == "error"


def test_voxelization_stage_outputs(tmp_path):
    from latticeurbanwind_tpu.pre.voxelization import main as luwvox
    from latticeurbanwind_tpu.geometry import read_stl

    case = tmp_path / "vox"
    (case / "proj_temp").mkdir(parents=True)
    (case / "conf.luw").write_text(
        "casename = vx\nsi_x_cfd = [0, 1000]\nsi_y_cfd = [0, 800]\n"
        "si_z_cfd = [0, 300]\nbase_height = 20\n"
        "terr_voxel_grid_resolution = 100\nterr_voxel_approach = idw\n")
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(0, 1000, 200), rng.uniform(0, 800, 200),
                    10 * np.sin(rng.uniform(0, 6, 200))], axis=1)
    np.savetxt(case / "proj_temp" / "dem_points.csv", pts, delimiter=",",
               header="x,y,elevation", comments="")
    (case / "proj_temp" / "buildings.csv").write_text(
        "id,x,y,height\n0,100,100,50\n0,200,100,50\n0,200,200,50\n0,100,200,50\n")
    assert luwvox([str(case / "conf.luw")]) == 0
    stl = read_stl(case / "proj_temp" / "vx_DG.stl")
    assert len(stl.tris) > 100
    np.testing.assert_allclose(stl.pmin[:2], [0, 0], atol=1e-3)
    np.testing.assert_allclose(stl.pmax[:2], [1000, 800], atol=1e-3)
    assert stl.pmax[2] > 50  # building above terrain
    dem = np.loadtxt(case / "proj_temp" / "interpolated_dem.csv",
                     delimiter=",", skiprows=1)
    assert dem.shape[1] == 3


def test_netcdf_export_round_trip(tmp_path):
    from scipy.io import netcdf_file

    from latticeurbanwind_tpu.post.vtk2nc import write_netcdf

    lon = np.linspace(121, 122, 5)
    lat = np.linspace(31, 32, 4)
    z = np.array([10.0, 50.0])
    u = np.arange(2 * 4 * 5, dtype=np.float32).reshape(2, 4, 5)
    path = write_netcdf(tmp_path / "t.nc", lon, lat, z, {"ue": u})
    with netcdf_file(str(path), "r", mmap=False) as nc:
        np.testing.assert_allclose(nc.variables["ue"][:], u)
        np.testing.assert_allclose(nc.variables["lon"][:], lon)


def _tiny_avg_case(tmp_path, with_geo=True):
    """Minimal case dir: deck + one avg VTK with u_avg/tke/fluid fields."""
    import numpy as np
    from latticeurbanwind_tpu.deck import parse_deck_text
    from latticeurbanwind_tpu.io.vtk import write_structured_points

    home = tmp_path / "case"
    (home / "RESULTS" / "vtk").mkdir(parents=True)
    text = ("// LUW deck\ncasename = t\ndatetime = 20250101000000\n"
            "base_height = 20\n")
    if with_geo:
        text += ("cut_lon_manual = [121.30, 121.34]\n"
                 "cut_lat_manual = [31.10, 31.13]\n"
                 'utm_crs = "EPSG:32651"\nrotate_deg = 0.5\n')
    deck = parse_deck_text(text)
    deck.save(home / "conf.luw")
    nz, ny, nx = 6, 20, 24
    rng = np.random.default_rng(0)
    u = rng.uniform(1, 5, (3, nz, ny, nx)).astype(np.float32)
    fields = {
        "u_avg": u,
        "rho_avg": np.full((nz, ny, nx), 1.2, np.float32),
        "tke": rng.uniform(0, 1, (nz, ny, nx)).astype(np.float32),
        "fluid": np.ones((nz, ny, nx), np.float32),
    }
    vtk = home / "RESULTS" / "vtk" / "ANG_0_20250101000000_avg-000000100.vtk"
    write_structured_points(vtk, fields, spacing=10.0)
    return home, vtk, fields


def test_visluw_netcdf_export_structure(tmp_path):
    """The docstring-promised NetCDF export exists and carries the full 3-D
    field in lon/lat coordinates (reference visluw.py spec item 8)."""
    import numpy as np
    from scipy.io import netcdf_file

    from latticeurbanwind_tpu.post.visluw import render_layers

    home, vtk, fields = _tiny_avg_case(tmp_path)
    written = render_layers(home / "conf.luw", vtk, sections=3, write_nc=True)
    pngs = [p for p in written if p.suffix == ".png"]
    ncs = [p for p in written if p.suffix == ".nc"]
    assert len(pngs) == 3 and len(ncs) == 1
    assert ncs[0].name == vtk.stem + "_visluw.nc"
    with netcdf_file(str(ncs[0]), "r", mmap=False) as nc:
        assert set(nc.variables) >= {"lon", "lat", "height", "u", "v", "w", "tke"}
        nz, ny, nx = 6, 20, 24
        assert nc.variables["u"].shape == (nz, ny, nx)
        lon = np.array(nc.variables["lon"][:])
        assert 121.29 < lon.min() < lon.max() < 121.35
        # u round-trips bit-exactly (no regrid in the visluw export)
        assert np.allclose(np.array(nc.variables["u"][:]), fields["u_avg"][0])


def test_visluw_height_selection(tmp_path):
    """Explicit --heights pick the nearest layers above the base pedestal
    and name figures wind_<height>m.png (reference spec items 1/4)."""
    from latticeurbanwind_tpu.post.visluw import render_layers

    home, vtk, _ = _tiny_avg_case(tmp_path, with_geo=False)
    written = render_layers(home / "conf.luw", vtk, heights=[12.0, 32.0],
                            write_nc=False)
    names = sorted(p.name for p in written)
    # layer centers 5,15,25,... m; base 20 m -> usable heights 5,15,25,35
    assert names == ["wind_15m.png", "wind_35m.png"]


def test_season_windrose_weight_derivation(tmp_path):
    """Direction weights from the joint windrose table: probability,
    velocity (v/vref) and tke ((v/vref)^2) weights match hand math
    (reference season_average.py:546-660)."""
    import numpy as np

    from latticeurbanwind_tpu.post.season_average import (
        derive_direction_weights, parse_windrose_csv,
    )

    home = tmp_path / "case"
    (home / "wind_bc").mkdir(parents=True)
    # profile: linear 0.5*z -> at 10 m the reference speed is 5 m/s
    (home / "wind_bc" / "profile.dat").write_text(
        "z,U\n1\t0.5\n10\t5.0\n100\t50.0\n")
    # two directions, two bins: C1 centers 2, C2 centers 6
    (home / "wind_bc" / "windrose_10m.csv").write_text(
        "dir,C1_0_4,C2_4_8\nN,10,30\nE,40,20\n")
    targets, table, total = parse_windrose_csv(home / "wind_bc" / "windrose_10m.csv")
    assert np.allclose(targets, [2.0, 6.0])
    assert abs(total - 1.0) < 1e-9          # percentage table scaled by 0.01
    weights = {a: (v, t, p) for a, v, t, p in derive_direction_weights(home)}
    # N: joint (0.1, 0.3); ratios (0.4, 1.2) -> v = 0.04+0.36 = 0.4
    v, t, p = weights[0.0]
    assert abs(p - 0.4) < 1e-9
    assert abs(v - (0.1 * 0.4 + 0.3 * 1.2)) < 1e-9
    assert abs(t - (0.1 * 0.16 + 0.3 * 1.44)) < 1e-9
    # E: joint (0.4, 0.2) -> v = 0.16 + 0.24 = 0.4
    v, t, p = weights[90.0]
    assert abs(p - 0.6) < 1e-9
    assert abs(v - (0.4 * 0.4 + 0.2 * 1.2)) < 1e-9


def test_cutvis_geo_crop_outputs(tmp_path):
    """Geo-mode crop exports <stem>_cropped.vtk with shrunken dims plus the
    wind/tke figure pair (reference batch_tke_geo_viz.py contract)."""
    import numpy as np

    from latticeurbanwind_tpu.deck import load_deck
    from latticeurbanwind_tpu.io.vtk import read_structured_points
    from latticeurbanwind_tpu.post.cut_vis import main as cutvis_main

    home, vtk, _ = _tiny_avg_case(tmp_path)
    deck = load_deck(home / "conf.luw")
    # a ~90 x 60 m window around the domain center (the toy VTK spans only
    # 240 x 200 m of the cut window's central patch)
    deck.set_float("crop_min_lon", 121.3195)
    deck.set_float("crop_max_lon", 121.3205)
    deck.set_float("crop_min_lat", 31.11470)
    deck.set_float("crop_max_lat", 31.11530)
    deck.set_float("crop_vis_dpi", 60)
    deck.save()
    assert cutvis_main([str(home / "conf.luw")]) == 0
    cropped = vtk.with_name(vtk.stem + "_cropped.vtk")
    assert cropped.exists()
    meta, fields = read_structured_points(cropped)
    assert meta["dims"][0] < 24 and meta["dims"][1] < 20
    assert "u_avg" in fields and "tke" in fields
    figs = sorted((home / "RESULTS" / "figures").glob("*.png"))
    assert any("wind9" in f.name for f in figs)
    assert any("tke9" in f.name for f in figs)


def test_les_spectra_horizontal_layers(tmp_path):
    """Per-layer kx-ky spectra + overview + metadata CSV with coverage
    fractions (reference les_spectra.py:187-402)."""
    import numpy as np

    from latticeurbanwind_tpu.post.les_spectra import (
        horizontal_layer_report, horizontal_spectrum, layer_ladder,
    )

    home, vtk, fields = _tiny_avg_case(tmp_path, with_geo=False)
    fig_dir = home / "RESULTS" / "figures"
    fig_dir.mkdir(parents=True)
    written = horizontal_layer_report(vtk, fig_dir, dz_target=20.0)
    names = [p.name for p in written]
    assert any("kxky_overview" in n for n in names)
    assert any(n.endswith("_kxky_layers.csv") for n in names)
    assert sum(n.endswith(".png") for n in names) >= 2

    # a pure sine layer concentrates energy at its wavenumber
    Y, X, sp = 64, 64, 2.0
    x = np.arange(X) * sp
    lay = np.sin(2 * np.pi * 4 * x / (X * sp))[None, :] * np.ones((Y, 1))
    kx, ky, E = horizontal_spectrum(lay, sp)
    peak = np.unravel_index(E.argmax(), E.shape)
    k_peak = abs(kx[peak[1]])
    assert abs(k_peak - 4 / (X * sp)) < 1.5 / (X * sp)
    assert len(layer_ladder(10, 10.0, 0.0, 30.0)) == 4


def test_cutvis_cli_option_surface(tmp_path):
    """Reference cut_vis CLI flags (tools_core/cut_vis.py:1281-1348): XY
    bound overrides beat lon/lat-derived bounds, --no-cropped-vtk gates the
    export, --output-dir/--dpi/--quiver-step restyle the figures."""
    from latticeurbanwind_tpu.io.vtk import read_structured_points
    from latticeurbanwind_tpu.post.cut_vis import main as cutvis_main

    home, vtk, _ = _tiny_avg_case(tmp_path)
    figdir = tmp_path / "figs"
    assert cutvis_main([
        str(home / "conf.luw"), "--min-x", "40", "--max-x", "160",
        "--min-y", "30", "--max-y", "130", "--dpi", "50",
        "--quiver-step", "3", "--output-dir", str(figdir)]) == 0
    cropped = vtk.with_name(vtk.stem + "_cropped.vtk")
    assert cropped.exists()
    meta, _ = read_structured_points(cropped)
    assert meta["dims"][0] <= 13 and meta["dims"][1] <= 11  # 120 x 100 m box
    assert any("wind9" in f.name for f in figdir.glob("*.png"))

    cropped.unlink()
    assert cutvis_main([
        str(home / "conf.luw"), "20", "180", "20", "160",
        "--no-cropped-vtk", "--dpi", "50",
        "--output-dir", str(figdir)]) == 0
    assert not cropped.exists()              # export gated off


def test_visluw_cli_crop_and_outputs(tmp_path):
    """Reference visluw CLI flags (visluw.py:676-684): lon/lat crop window,
    --layers alias, --output-dir, --nc-output."""
    from scipy.io import netcdf_file

    from latticeurbanwind_tpu.post.visluw import main as visluw_main

    home, vtk, _ = _tiny_avg_case(tmp_path)
    figdir = tmp_path / "secfigs"
    ncout = tmp_path / "crop.nc"
    rc = visluw_main([
        str(home / "conf.luw"), "--layers", "2",
        "--lon-min", "121.3005", "--lon-max", "121.3018",
        "--lat-min", "31.0999", "--lat-max", "31.1012",
        "--output-dir", str(figdir), "--nc-output", str(ncout)])
    assert rc == 0
    assert len(list(figdir.glob("wind_*m.png"))) == 2
    with netcdf_file(str(ncout), "r", mmap=False) as nc:
        u = nc.variables["u"]
        assert u.shape[0] == 6 and u.shape[1] < 20 and u.shape[2] < 24
    # partial window is rejected
    assert visluw_main([str(home / "conf.luw"), "--lon-min", "121.3005"]) == 2


def test_season_synthesize_full_surface(tmp_path):
    """Season synthesis end-to-end with the reference CLI surface: explicit
    weights, highest-step source picking, --output-spacing trilinear
    resample, summary + figure artifacts, --vtk-dir override
    (reference season_average.py:1319-1499 resample, :1631 summary,
    :1707-1724 CLI)."""
    import numpy as np

    from latticeurbanwind_tpu.io.vtk import (read_structured_points,
                                             write_structured_points)
    from latticeurbanwind_tpu.post.season_average import main as season_main

    home = tmp_path / "case"
    vtk_dir = home / "RESULTS" / "vtk"
    vtk_dir.mkdir(parents=True)
    (home / "conf.luwpf").write_text(
        "// Project\ncasename = demo\ndatetime = 20260101\n")
    Z, Y, X = 6, 10, 12
    for ang, mag in ((0.0, 1.0), (90.0, 3.0)):
        u = np.full((3, Z, Y, X), mag, np.float32)
        tke = np.full((Z, Y, X), mag, np.float32)
        # an older lower-step file that must be ignored
        write_structured_points(
            vtk_dir / f"ANG_{ang:g}_20260101_avg-000000005.vtk",
            {"u_avg": u * 100, "tke": tke * 100}, spacing=5.0)
        write_structured_points(
            vtk_dir / f"ANG_{ang:g}_20260101_avg-000000050.vtk",
            {"u_avg": u, "tke": tke}, spacing=5.0)
    weights = home / "w.csv"
    weights.write_text("angle,weight,scale\n0,1,1\n90,3,1\n")

    rc = season_main([str(home / "conf.luwpf"), str(weights),
                      "--output-spacing", "2.5", "--dpi", "50"])
    assert rc == 0
    out = vtk_dir / "SEASON_20260101_avg.vtk"
    meta, fields = read_structured_points(out)
    # 5 m -> 2.5 m doubles the grid (extent preserved: 2*(n-1)+1)
    assert tuple(meta["dims"]) == (2 * (X - 1) + 1, 2 * (Y - 1) + 1,
                                   2 * (Z - 1) + 1)
    assert np.allclose(meta["spacing"], [2.5, 2.5, 2.5])
    # weighted mean of constants: u = 0.25*1 + 0.75*3 = 2.5 exactly
    # (trilinear resample of a constant stays constant)
    assert np.allclose(fields["u_avg"], 2.5, atol=1e-5)
    # tke uses the squared-scale weight; scale=1 -> same 2.5
    assert np.allclose(fields["tke"], 2.5, atol=1e-5)
    assert (home / "RESULTS" / "season_summary.txt").exists()
    figs = list((home / "RESULTS" / "figures").glob("season_*.png"))
    assert any("wind" in f.name for f in figs)
    assert any("tke" in f.name for f in figs)

    # --vtk-dir override + --skip-figures: a separate source tree
    alt = home / "alt_vtk"
    alt.mkdir()
    for f in vtk_dir.glob("ANG_*.vtk"):
        (alt / f.name).write_bytes(f.read_bytes())
    for f in list((home / "RESULTS" / "figures").glob("season_*.png")):
        f.unlink()
    rc = season_main([str(home / "conf.luwpf"), str(weights),
                      "--vtk-dir", "alt_vtk", "--skip-figures"])
    assert rc == 0
    assert not list((home / "RESULTS" / "figures").glob("season_*.png"))
    meta2, fields2 = read_structured_points(out)
    assert tuple(meta2["dims"]) == (X, Y, Z)
    assert np.allclose(fields2["u_avg"], 2.5, atol=1e-5)


def test_les_spectra_cli_surface(tmp_path):
    """Reference CLI surface: direct .vtk target, --output-dir,
    --height-interval/--height-start, --quick-test; isotropic E(k) over the
    fully-fluid subvolume with CSV (reference les_spectra.py:45-99 CLI,
    :414-652 isotropic)."""
    import numpy as np

    from latticeurbanwind_tpu.io.vtk import write_structured_points
    from latticeurbanwind_tpu.post.les_spectra import (
        full_coverage_z_start, main as spectra_main, spectrum_3d)

    rng = np.random.default_rng(3)
    Z, Y, X = 16, 24, 24
    u = rng.normal(2.0, 0.4, (3, Z, Y, X)).astype(np.float32)
    fluid = np.ones((Z, Y, X), np.float32)
    fluid[:4, 5:9, 5:9] = 0.0           # buildings in the lowest layers
    vtk = tmp_path / "demo_raw_u-000000100.vtk"
    write_structured_points(vtk, {"u": u, "fluid": fluid}, spacing=10.0)

    assert full_coverage_z_start(fluid) == 4
    out_dir = tmp_path / "figs"
    # default origin centers the box: heights span about -70..80 m
    rc = spectra_main([str(vtk), "--output-dir", str(out_dir),
                       "--height-interval", "40", "--height-start", "0",
                       "--quick-test", "--test-height-count", "2"])
    assert rc == 0
    names = {p.name for p in out_dir.iterdir()}
    assert f"{vtk.stem}_Ek.png" in names and f"{vtk.stem}_Ek.csv" in names
    # quick-test limits the ladder to 2 heights (+ overview + layer csv)
    layer_pngs = [n for n in names if "_kxky_" in n and n.endswith("m.png")]
    assert len(layer_pngs) == 2
    # ladder respects --height-start: no layer below 0 m
    assert all(float(n.split("_kxky_")[1][:-5]) >= 0 for n in layer_pngs)

    # Parseval-ish sanity: multi-component E(k) integrates to ~0.5*var sum
    k, E = spectrum_3d(u, 10.0)
    var = sum(np.var(u[c]) for c in range(3))
    assert 0.2 * var < E.sum() * 2 < 5 * var  # loose: binning + windowless


def test_utmnc_single_deck_and_asl(tmp_path):
    """luwutmnc single-deck mode: pedestal strip + terrain ASL shift +
    derotated ue/vn on UTM axes (reference vtk_avg_to_utm_asl_nc.py
    pedestal/ASL semantics + parse_range_asl grammar)."""
    import numpy as np
    from scipy.io import netcdf_file

    from latticeurbanwind_tpu.post.vtk_avg_to_utm_asl_nc import (
        main as utm_main, parse_range_asl)

    home, vtk, fields = _tiny_avg_case(tmp_path)
    rng_file = tmp_path / "Range.txt"
    rng_file.write_text("case:\n  terrain_min_asl_m = 120.5\n")
    rc = utm_main([str(home / "conf.luw"), "--range-file", str(rng_file),
                   "--pedestal-height", "20", "--overwrite"])
    assert rc == 0
    out = home / "RESULTS" / "nc_utm_asl" / (vtk.stem + "_utm_asl.nc")
    assert out.exists()
    with netcdf_file(str(out), "r") as nc:
        z = np.array(nc.variables["z"][:])
        # spacing 10, pedestal 20 -> k0=2; first kept z-center = 25 - 20
        # + 120.5 ASL = 125.5
        assert abs(z[0] - 125.5) < 1e-4
        assert nc.dimensions["z"] == 4            # 6 layers - 2 pedestal
        for name in ("ue", "vn", "w", "tke"):
            assert name in nc.variables
        easting = np.array(nc.variables["easting"][:])
        assert easting[0] > 100_000               # true UTM meters
        assert float(nc.terrain_min_asl_m) == 120.5

    # skip-without-overwrite path
    rc = utm_main([str(home / "conf.luw"), "--terrain-min-asl", "120.5",
                   "--pedestal-height", "20"])
    assert rc == 1       # nothing written (skipped existing)

    # Range.txt alternate grammars
    alt = tmp_path / "alt.txt"
    alt.write_text("the beijing domain sits at 43 m\nshanghai:\n  5 m\n")
    vals = parse_range_asl(alt, ["beijing", "shanghai"])
    assert vals == {"beijing": 43.0, "shanghai": 5.0}


def test_utmnc_multicase_batch(tmp_path):
    """Batch mode over a case root with per-case Range.txt ASL values and
    --limit (reference --cases/--input-subdir/--limit surface)."""
    import numpy as np
    from scipy.io import netcdf_file

    from latticeurbanwind_tpu.post.vtk_avg_to_utm_asl_nc import (
        main as utm_main)

    root = tmp_path / "fleet"
    for name in ("alpha", "beta"):
        case = root / name
        _tiny_avg_case(case)                 # creates case/case/...
        (case / "case").rename(case / "tmp")
        for p in (case / "tmp").iterdir():
            p.rename(case / p.name)
        (case / "tmp").rmdir()
    rng_file = tmp_path / "Range.txt"
    rng_file.write_text("alpha: 10 m\nbeta: 20 m\n")
    rc = utm_main([str(root), "--cases", "alpha", "beta", "--range-file",
                   str(rng_file), "--limit", "1", "--overwrite"])
    assert rc == 0
    for name, asl in (("alpha", 10.0), ("beta", 20.0)):
        ncs = list((root / name / "RESULTS" / "nc_utm_asl").glob("*.nc"))
        assert len(ncs) == 1
        with netcdf_file(str(ncs[0]), "r") as nc:
            assert float(nc.terrain_min_asl_m) == asl


def test_cubic_regrid_beats_nearest_on_rotated_grid():
    """vtk2nc parity with the reference's cubic map_coordinates path
    (vtk2nc_new.py:588-660, 745-764): on a rotated source grid carrying a
    smooth field, (1) the derived target rectangle is fully covered (no
    extrapolated fringe), and (2) cubic reconstruction error is far below
    a nearest-sample regrid of the same mapping."""
    from latticeurbanwind_tpu.post.vtk2nc import LonLatRegridder

    theta = np.radians(23.0)

    class RotModel:
        # "lon/lat" = source local coords rotated by theta (pure geometry:
        # exercises the inverse mapping without the UTM series)
        def local_to_lonlat(self, x, y):
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            return (np.cos(theta) * x - np.sin(theta) * y,
                    np.sin(theta) * x + np.cos(theta) * y)

        def lonlat_to_local(self, lon, lat):
            lon = np.asarray(lon, np.float64)
            lat = np.asarray(lat, np.float64)
            return (np.cos(theta) * lon + np.sin(theta) * lat,
                    -np.sin(theta) * lon + np.cos(theta) * lat)

    nx, ny = 64, 48
    x = (np.arange(nx) + 0.5) * 10.0
    y = (np.arange(ny) + 0.5) * 10.0
    model = RotModel()
    rg = LonLatRegridder.build(model, x, y)
    assert len(rg.lon) >= 2 and len(rg.lat) >= 2

    def f(lon, lat):
        return np.sin(lon / 80.0) * np.cos(lat / 60.0)

    gx, gy = np.meshgrid(x, y)
    src_lon, src_lat = model.local_to_lonlat(gx, gy)
    vals = f(src_lon, src_lat)[None].astype(np.float32)

    out = rg(vals)[0]
    glon, glat = np.meshgrid(rg.lon, rg.lat)
    truth = f(glon, glat)
    cubic_err = np.abs(out - truth).max()

    # nearest baseline through the same fractional mapping
    yi = np.rint(rg._coords[0]).astype(int)
    xi = np.rint(rg._coords[1]).astype(int)
    nearest = vals[0][yi, xi].reshape(truth.shape)
    nearest_err = np.abs(nearest - truth).max()

    assert np.isfinite(out).all()
    assert cubic_err < 1e-3, cubic_err
    assert cubic_err < nearest_err / 10, (cubic_err, nearest_err)


def test_points_in_ring_matches_matplotlib_path():
    """luwcut's overlap test needs no matplotlib: its even-odd point-in-
    polygon agrees with matplotlib.path on a concave ring."""
    from matplotlib.path import Path as MplPath

    from latticeurbanwind_tpu.pre.shpcutter import _points_in_ring

    ring = np.array([[0, 0], [10, 0], [10, 10], [5, 4], [0, 10]], float)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-2, 12, size=(500, 2))
    np.testing.assert_array_equal(_points_in_ring(ring, pts),
                                  MplPath(ring).contains_points(pts))
