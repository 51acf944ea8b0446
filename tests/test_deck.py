"""Deck layer tests: fuzzy bools, aliases, canonical render, round-trips.

Mirrors the reference test strategy (/root/reference/tests/test_deck_io.py)
and extends it with mode masks and example-deck loading.
"""

from pathlib import Path

import pytest

from latticeurbanwind_tpu.deck import (
    DeckParseError,
    FIELD_MAP,
    FIELDS,
    SECTION_ORDER,
    deck_mode_from_path,
    normalize_key,
    parse_bool_token,
    parse_deck_text,
)


def test_schema_inventory():
    assert len(SECTION_ORDER) == 9
    assert len(FIELDS) == 82  # 77 reference fields + lbm_storage +
    # frame_output + case_parallel + ground_z0 + building_z0 (extensions)
    assert SECTION_ORDER[0] == "project" and SECTION_ORDER[-1] == "custom"


def test_fuzzy_bool_tokens():
    deck = parse_deck_text(
        """
        // Physics
        buoyancy = "yes"
        coriolis_term = t
        ibm_enabler = n
        enable_top_sponge = 0
        enable_buffer_nudging = 2
        """
    )
    assert deck.get_bool("buoyancy") is True
    assert deck.get_bool("coriolis_term") is True
    assert deck.get_bool("ibm_enabler") is False
    assert deck.get_bool("enable_top_sponge") is False
    assert deck.get_bool("enable_buffer_nudging") is True
    assert parse_bool_token("on") is True
    assert parse_bool_token("Disabled") is False
    assert parse_bool_token("nan") is None
    assert parse_bool_token("maybe") is None


def test_alias_keys_normalize():
    deck = parse_deck_text(
        """
        // Turbulence inflow
        vk-inlet-enable = "y"
        vk inlet anisotropy scale = [1.0, 2.0, 3.0]
        """
    )
    assert deck.has("turb_inflow_enable")
    assert deck.get_bool("turb_inflow_enable") is True
    assert deck.get_float_list("vk_inlet_anisotropy") == [1.0, 2.0, 3.0]
    assert normalize_key("VK Inlet TI") == "vk_inlet_ti"
    assert normalize_key("made--up Key") == "made_up_key"


def test_render_canonical_order_and_unknowns():
    deck = parse_deck_text(
        """
        custom_note = alpha
        probes =
        // CFD control
        gpu_memory = 24000
        vk_inlet_enable = yes
        mystery-key = 42
        // Domain
        cut_lon_manual = [121.7, 121.3]
        cut_lat_manual = [31.4, 31.1]
        """
    )
    deck.set_bool("flux_correction", True)
    rendered = deck.render()
    assert "// Domain" in rendered
    assert "// CFD Controls" in rendered
    assert "// Output & Probes" in rendered
    assert "probes =" in rendered
    assert "turb_inflow_enable = true" in rendered
    assert "mystery_key = 42" in rendered
    assert rendered.index("// Domain") < rendered.index("// CFD Controls")
    assert rendered.index("// CFD Controls") < rendered.index("// Output & Probes")


def test_quoted_fields_and_pairs():
    deck = parse_deck_text(
        """
        // Domain
        utm_crs = EPSG:32651
        si_x_cfd = [100.0, 0.0]
        // CFD Controls
        n_gpu = [2, 1, 1]
        mesh_control = "gpu_memory"
        """
    )
    assert deck.get_text("utm_crs") == "EPSG:32651"
    assert 'utm_crs = "EPSG:32651"' in deck.render()
    assert deck.get_pair("si_x_cfd") == (0.0, 100.0)
    assert deck.get_int_list("n_gpu") == [2, 1, 1]
    assert deck.get_text("mesh_control") == "gpu_memory"


def test_duplicates_tracked_and_strict_mode():
    text = """
    casename = a
    casename = b
    """
    deck = parse_deck_text(text)
    assert deck.get_text("casename") == "b"
    assert deck.duplicate_keys() == ["casename"]
    with pytest.raises(DeckParseError):
        parse_deck_text(text, strict_duplicates=True)


def test_comments_preserved_and_quote_aware():
    deck = parse_deck_text('casename = "with // slash" // trailing note\n')
    assert deck.get_text("casename") == "with // slash"
    assert "// trailing note" in deck.render()


def test_round_trip_idempotent():
    deck = parse_deck_text(
        """
        // Project
        casename = CaseE
        // Domain
        si_x_cfd = [0.000000, 2022.500153]
        base_height = 20.0
        // CFD Controls
        n_gpu = [2, 1, 1]
        cell_size =
        // Batch
        angle = [0, 90, 180, 270]
        """
    )
    once = deck.render()
    again = parse_deck_text(once).render()
    assert once == again


def test_terrain_voxel_keys_round_trip():
    deck = parse_deck_text(
        """
        // Domain
        terr_voxel_height_field = HEIGHT_M
        terr_voxel_ignore_under = 3.500000
        terr_voxel_approach = kriging_gpu
        terr_voxel_grid_resolution = 25.000000
        terr_voxel_idw_sigma = 0.500000
        terr_voxel_idw_power = 1.500000
        terr_voxel_idw_neighbors = 8
        """
    )
    assert deck.get_text("terr_voxel_height_field") == "HEIGHT_M"
    assert deck.get_float("terr_voxel_ignore_under") == 3.5
    assert deck.get_text("terr_voxel_approach") == "kriging_gpu"
    assert deck.get_float("terr_voxel_grid_resolution") == 25.0
    assert deck.get_float("terr_voxel_idw_sigma") == 0.5
    assert deck.get_float("terr_voxel_idw_power") == 1.5
    assert deck.get_int("terr_voxel_idw_neighbors") == 8
    rendered = deck.render()
    assert "terr_voxel_approach = kriging_gpu" in rendered
    assert "terr_voxel_idw_neighbors = 8" in rendered


def test_mode_from_path():
    assert deck_mode_from_path("conf.luw") == "luw"
    assert deck_mode_from_path("conf.luwdg") == "luwdg"
    assert deck_mode_from_path("conf.luwpf") == "luwpf"
    with pytest.raises(ValueError):
        deck_mode_from_path("conf.toml")


def test_writeback_preserves_structure(tmp_path: Path):
    deck = parse_deck_text("// Project\ncasename = demo\n")
    deck.set_pair("si_x_cfd", (0.0, 1000.0))
    deck.set_list("um_vol", [0.1, 0.2, 0.3])
    deck.set_text("downstream_bc", "+y", quoted=True)
    deck.set_float("downstream_bc_yaw", 30.19, precision=2)
    target = tmp_path / "conf.luw"
    deck.save(target)
    reloaded = parse_deck_text(target.read_text())
    assert reloaded.get_pair("si_x_cfd") == (0.0, 1000.0)
    assert reloaded.get_float_list("um_vol") == [0.1, 0.2, 0.3]
    assert reloaded.get_text("downstream_bc") == "+y"
    assert reloaded.get_float("downstream_bc_yaw") == 30.19


def test_field_kinds_sane():
    assert FIELD_MAP["n_gpu"].kind == "uint_triplet"
    assert FIELD_MAP["probes"].kind == "multiline"
    assert FIELD_MAP["utm_crs"].quoted
    assert FIELD_MAP["inflow"].modes == 2  # luwdg only
