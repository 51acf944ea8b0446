"""dgPrepare geometry prep + buildingscale morphology on the real example."""

import shutil
from pathlib import Path

import numpy as np
import pytest

from latticeurbanwind_tpu.deck import load_deck
from latticeurbanwind_tpu.geometry import read_stl


def test_dgprepare_reproduces_case_e_extents(tmp_path):
    from latticeurbanwind_tpu.pre.dgprepare import main as dgprepare

    case = tmp_path / "dg"
    (case / "building_db").mkdir(parents=True)
    example = (Path(__file__).resolve().parents[1] / "examples"
               / "example_ProfileResearch_noDEM")
    shutil.copy(example / "building_db" / "rawbuildings.stl",
                case / "building_db" / "rawbuildings.stl")
    (case / "conf.luwpf").write_text(
        "casename = CityDemo\nbase_height = 16.0\nz_limit = 120\n"
        "x_exp_rat = 3\ny_exp_rat = 3\nangle = [0]\n")
    assert dgprepare([str(case / "conf.luwpf")]) == 0
    deck = load_deck(case / "conf.luwpf")
    # must reproduce the extents the example deck records
    # (si_x_cfd = [0, 636], si_y_cfd = [0, 636], si_z_cfd = [0, 136])
    ref = load_deck(example / "conf.luwpf")
    assert deck.get_pair("si_x_cfd")[1] == pytest.approx(
        ref.get_pair("si_x_cfd")[1], abs=0.01)
    assert deck.get_pair("si_y_cfd")[1] == pytest.approx(
        ref.get_pair("si_y_cfd")[1], abs=0.01)
    assert deck.get_pair("si_z_cfd") == ref.get_pair("si_z_cfd")
    stl = read_stl(case / "proj_temp" / "CityDemo_PF.stl")
    np.testing.assert_allclose(stl.pmin, [0, 0, 0], atol=1e-3)


def test_morphology_stats():
    from latticeurbanwind_tpu.post.buildingscale import morphology_stats

    solid = np.zeros((10, 8, 8), dtype=bool)
    solid[0] = True                      # ground plane
    solid[1:6, 2:4, 2:4] = True          # one 2x2 tower, 5 cells tall
    stats = morphology_stats(solid, cell_m=10.0, ground_k=1)
    assert stats["lambda_p"] == pytest.approx(4 / 64)
    assert stats["mean_height_m"] == pytest.approx(50.0)
    assert stats["max_height_m"] == pytest.approx(50.0)
    assert stats["built_columns"] == 4
    assert stats["lambda_f_x"] > 0
