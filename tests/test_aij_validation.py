"""AIJ Case E validation tooling: xls reader + point sampling + stats.

The BIFF record layer is tested synthetically; the full OLE2 path runs
against the reference's shipped CaseE workbook (skipped if absent).
"""

import struct
from pathlib import Path

import numpy as np
import pytest

from latticeurbanwind_tpu.io.xls import (
    _decode_rk, _parse_sst, _records, load_xls,
)
from latticeurbanwind_tpu.post.aij_casee import (
    COMPASS16, compare, compass_column, load_aij_casee, reference_speed,
    sample_ratios,
)

CASEE_XLS = Path("/root/reference/examples/example_ProfileResearch_noDEM/"
                 "CaseE(Niigata).xls")


def _rec(rid, body):
    return struct.pack("<HH", rid, len(body)) + body


def test_decode_rk_variants():
    # integer RK: value << 2 | 0b10
    assert _decode_rk((42 << 2) | 2) == 42.0
    assert _decode_rk(((-7 & 0x3FFFFFFF) << 2 | 2) & 0xFFFFFFFF) == -7.0
    # float RK: top 30 bits of an IEEE double
    bits = struct.unpack("<Q", struct.pack("<d", 2.5))[0]
    assert _decode_rk((bits >> 32) & 0xFFFFFFFC) == 2.5
    # div-100 flag
    assert _decode_rk(((150 << 2) | 2) | 1) == 1.5


def test_biff_record_walk_and_cells():
    # NUMBER + RK + MULRK + LABELSST rows, SST with one string
    sst_body = struct.pack("<II", 1, 1) + struct.pack("<HB", 5, 0) + b"hello"
    stream = b"".join([
        _rec(0x00FC, sst_body),
        _rec(0x0203, struct.pack("<HHH", 0, 0, 0) + struct.pack("<d", 3.25)),
        _rec(0x027E, struct.pack("<HHHI", 0, 1, 0, (9 << 2) | 2)),
        _rec(0x00BD, struct.pack("<HH", 1, 0)
             + struct.pack("<HI", 0, (10 << 2) | 2)
             + struct.pack("<HI", 0, (20 << 2) | 2)
             + struct.pack("<H", 1)),
        _rec(0x00FD, struct.pack("<HHHI", 2, 0, 0, 0)),
    ])
    recs = dict()
    cells = {}
    sst = []
    for rid, bodies in _records(stream):
        body = bodies[0]
        recs.setdefault(rid, 0)
        recs[rid] += 1
        if rid == 0x00FC:
            sst = _parse_sst(bodies)
        elif rid == 0x0203:
            r, c = struct.unpack_from("<HH", body, 0)
            cells[(r, c)] = struct.unpack_from("<d", body, 6)[0]
        elif rid == 0x027E:
            r, c = struct.unpack_from("<HH", body, 0)
            cells[(r, c)] = _decode_rk(struct.unpack_from("<I", body, 6)[0])
        elif rid == 0x00BD:
            r, c0 = struct.unpack_from("<HH", body, 0)
            for i in range((len(body) - 6) // 6):
                rk = struct.unpack_from("<I", body, 4 + 6 * i + 2)[0]
                cells[(r, c0 + i)] = _decode_rk(rk)
        elif rid == 0x00FD:
            r, c, _, isst = struct.unpack_from("<HHHI", body, 0)
            cells[(r, c)] = sst[isst]
    assert sst == ["hello"]
    assert cells[(0, 0)] == 3.25
    assert cells[(0, 1)] == 9.0
    assert cells[(1, 0)] == 10.0 and cells[(1, 1)] == 20.0
    assert cells[(2, 0)] == "hello"


def test_sst_continue_reassembly():
    # a 6-char wide string split across a CONTINUE boundary
    part1 = struct.pack("<II", 1, 1) + struct.pack("<HB", 6, 1) \
        + "abc".encode("utf-16-le")
    part2 = b"\x01" + "def".encode("utf-16-le")
    out = _parse_sst([part1, part2])
    assert out == ["abcdef"]


@pytest.mark.skipif(not CASEE_XLS.exists(), reason="reference data absent")
def test_casee_workbook_loads():
    wb = load_xls(CASEE_XLS)
    assert wb.sheet_names == [
        "Geometry&Points", "Inflow",
        "Results (Before Construction)", "Results (After Construction)"]
    ds = load_aij_casee(CASEE_XLS)
    assert ds.points.shape == (80, 2)
    assert ds.ratios["after"].shape == (80, 16)
    assert ds.ratios["before"].shape == (80, 16)
    assert np.isfinite(ds.ratios["after"]).all()
    # inflow profile is profile.dat normalized by ZR=250 m, UR=7.8 m/s
    assert ds.inflow_z_zr[0] == pytest.approx(0.005)
    assert ds.inflow_u_ur[-1] == pytest.approx(1.0)
    # measurement points sit inside the reproducing area (|x|,|y| < 250 m)
    assert np.abs(ds.points).max() < 250


@pytest.mark.skipif(not CASEE_XLS.exists(), reason="reference data absent")
def test_casee_reference_speed_matches_inflow_sheet():
    from latticeurbanwind_tpu.bc.profile import load_profile_dat

    ds = load_aij_casee(CASEE_XLS)
    z, u = load_profile_dat(CASEE_XLS.parent / "wind_bc" / "profile.dat")
    u_ref = reference_speed(z, u)
    lin = np.interp(15.9, ds.inflow_z_zr * 250.0, ds.inflow_u_ur * 7.8)
    assert u_ref == pytest.approx(lin, rel=0.02)   # cubic vs linear


def test_compass_column_mapping():
    assert compass_column(0) == 0
    assert compass_column(90) == COMPASS16.index("E")
    assert compass_column(180) == COMPASS16.index("S")
    assert compass_column(270) == COMPASS16.index("W")
    assert compass_column(22.5) == COMPASS16.index("NNE")
    assert compass_column(359) == 0
    assert compass_column(-90) == COMPASS16.index("W")


def test_sample_ratios_bilinear_and_solid_renormalization():
    # 8x8x8 box, spacing 4 m, centered origin like io/vtk writes it
    sp = 4.0
    Z = Y = X = 8
    origin = (sp * (0.5 - X / 2), sp * (0.5 - Y / 2), sp * (0.5 - Z / 2))
    meta = {"origin": origin, "spacing": (sp, sp, sp)}
    u = np.zeros((3, Z, Y, X), np.float32)
    u[0] = 3.0                        # uniform 3 m/s +x wind
    u[1] = 4.0                        # speed 5
    fluid = np.ones((Z, Y, X), np.float32)
    # base_height 4 -> measure layer z = 6 m -> k = 1
    fields = {"u_avg": u, "fluid": fluid}
    pts = np.array([[0.0, 0.0], [2.0, 0.0]])
    r = sample_ratios(meta, fields, pts, u_ref_si=10.0, base_height_m=4.0)
    assert r == pytest.approx([0.5, 0.5])

    # make one stencil cell solid with a absurd value: must drop out
    u[0, 1, 3, 3] = 1000.0
    fluid[1, 3, 3] = 0.0
    r2 = sample_ratios(meta, fields, pts, u_ref_si=10.0, base_height_m=4.0)
    assert r2 == pytest.approx([0.5, 0.5])

    # a point outside the grid -> NaN
    r3 = sample_ratios(meta, fields, np.array([[1e5, 0.0]]),
                       u_ref_si=10.0, base_height_m=4.0)
    assert np.isnan(r3[0])


def test_compare_statistics():
    m = np.array([0.2, 0.4, 0.6, 0.8])
    s = compare(m, m.copy())
    assert s["r"] == pytest.approx(1.0)
    assert s["rmse"] == 0.0
    assert s["within30"] == 1.0
    s2 = compare(m, m + 0.1)
    assert s2["bias"] == pytest.approx(0.1)
    # NaNs drop out
    c = m.copy()
    c[0] = np.nan
    assert compare(m, c)["n"] == 3


def test_reference_speed_normalized_profile():
    """Normalized profile.dat (z in z/ZR) must rescale by the run's domain
    height — and refuse to guess when it isn't given."""
    z_m = np.array([1.25, 12.5, 125.0, 250.0])
    u = np.array([2.847, 3.7674, 6.5, 7.8])
    z_norm = z_m / 250.0
    with pytest.raises(ValueError):
        reference_speed(z_norm, u)
    v_norm = reference_speed(z_norm, u, domain_agl_m=250.0)
    v_metric = reference_speed(z_m, u)
    assert v_norm == pytest.approx(v_metric, rel=1e-6)


def test_production_run_record_pinned():
    """The production study record (docs/casee_validation.json) stays at
    or above the achieved agreement: the comparison pipeline reading this
    file is the same code path luwaij runs, so a silent regression in the
    xls parsing / sampling / statistics would show up as a changed record.
    Updated whenever a better production run lands."""
    import json
    from pathlib import Path

    rec = json.loads((Path(__file__).resolve().parents[1] / "docs"
                      / "casee_validation.json").read_text())
    assert rec["cell_m"] <= 4.0 and rec["steps"] >= 20001
    assert rec["vk"] == "on" and rec["ground_z0"] > 0
    assert len(rec["angles"]) >= 4
    overall = rec["overall"]
    assert overall["n"] >= 320
    assert overall["r"] >= 0.61, "production agreement regressed"
    assert overall["bias"] > -0.25, "street-level bias regressed"
    # construction-variant discrimination: the wrong city must score far
    # worse than the shipped configuration
    assert rec["overall_before_variant"]["r"] < overall["r"] - 0.3
    # at least one direction in the AIJ-literature band
    assert max(a["r"] for a in rec["angles"].values()) >= 0.70
