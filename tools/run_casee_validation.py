"""AIJ Niigata Case E validation study driver.

Stages the reference-shipped Case E workspace (geometry STL + profile.dat +
the wind-tunnel .xls) into a scratch directory, runs the .luwpf profile
batch on the requested angles at the requested resolution on the current
JAX backend (the GPU when present), then runs `luwaij` against the
measurements and prints/records the comparison statistics.

Usage:
  python tools/run_casee_validation.py [--cell 4] [--angles 0,90,180,270]
      [--steps 20001] [--avg 5000] [--stride 5] [--work /tmp/casee_run]
      [--src /root/reference/examples/example_ProfileResearch_noDEM]
      [--variant after] [--keep-results]

The study methodology (documented in docs/VALIDATION.md):
  * domain 2022.5 x 1996.5 x 270 m as shipped (building area centered, 5x
    expansion), base pedestal 20 m, z_limit 250 m;
  * deck angles map to the xls compass columns (0=N, 90=E, ...): the wind
    comes FROM the compass direction (direction_from_angle);
  * measured quantity: wind speed at 2 m above ground normalized by the
    inflow speed at 15.9 m (the Niigata met-station height), at 80 points;
  * the model samples the time-averaged |u_h| at the first fluid layer at
    or above 2 m AGL, bilinear in-plane, solid-aware.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

DEFAULT_SRC = Path("/root/reference/examples/example_ProfileResearch_noDEM")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", type=float, default=4.0)
    ap.add_argument("--angles", default="0,90,180,270")
    ap.add_argument("--steps", type=int, default=20001)
    ap.add_argument("--avg", type=int, default=5000)
    ap.add_argument("--stride", type=int, default=5)
    ap.add_argument("--work", default="/tmp/casee_run")
    ap.add_argument("--src", default=str(DEFAULT_SRC))
    ap.add_argument("--variant", choices=("before", "after"), default="after")
    ap.add_argument("--storage", default="bf16")
    ap.add_argument("--vk", default="on", choices=("on", "off"))
    ap.add_argument("--vk-stride", type=int, default=1,
                    help="vk_inlet_update_stride: >1 amortizes the inlet "
                         "refresh over N steps (with temporal interpolation "
                         "— spectrum-fidelity pinned by tests/test_vk_inlet"
                         ".py::test_stride_interpolation_preserves_inlet_"
                         "spectrum: the VK band ends far below the stride-4 "
                         "Nyquist)")
    ap.add_argument("--z0", type=float, default=0.0,
                    help="ground_z0 (m): >0 enables the LES wall model "
                         "(specular ground + Schumann stress); the Case E "
                         "inflow profile fits z0 = 0.055 m (alpha = 0.2 "
                         "power law, AIJ terrain category III)")
    ap.add_argument("--building-z0", type=float, default=0.0,
                    help="building_z0 (m): >0 enables the vertical-face "
                         "wall model (specular sides + tangential Schumann "
                         "stress), -1 = pure free-slip sides; needs --z0")
    ap.add_argument("--max-cases", type=int, default=0)
    ap.add_argument("--out", default=str(REPO / "docs"))
    args = ap.parse_args()

    src = Path(args.src)
    work = Path(args.work)
    angles = [float(a) for a in args.angles.split(",")]

    if not work.exists():
        work.mkdir(parents=True)
        for sub in ("conf.luwpf", "wind_bc", "proj_temp", "building_db"):
            s = src / sub
            if s.is_dir():
                shutil.copytree(s, work / sub)
            elif s.exists():
                shutil.copy(s, work / sub)
        xls = sorted(src.glob("*.xls"))
        if xls:
            shutil.copy(xls[0], work / xls[0].name)

    from latticeurbanwind_tpu.deck import load_deck

    deck = load_deck(work / "conf.luwpf")
    deck.set_text("mesh_control", "cell_size", quoted=True)
    deck.set_float("cell_size", args.cell)
    deck.set_int("run_nstep", args.steps)
    deck.set_int("purge_avg", args.avg)
    deck.set_int("purge_avg_stride", args.stride)
    deck.set_list("angle", angles)
    deck.set_text("lbm_storage", args.storage)
    deck.set_bool("turb_inflow_enable", args.vk == "on")
    if args.vk_stride > 1:
        deck.set_int("vk_inlet_update_stride", args.vk_stride)
        deck.set_bool("vk_inlet_stride_interpolation", True)
    if args.z0 > 0:
        deck.set_float("ground_z0", args.z0)
    if args.building_z0 != 0.0:
        deck.set_float("building_z0", args.building_z0)
    deck.set_list("n_gpu", [1, 1, 1])
    deck.save()

    from latticeurbanwind_tpu.run import run_deck

    t0 = time.time()
    results = run_deck(work / "conf.luwpf", max_cases=args.max_cases)
    solve_s = time.time() - t0
    print(f"=== solve done: {len(results)} case(s) in {solve_s:.0f} s ===")

    from latticeurbanwind_tpu.post.aij_casee import validate_deck

    xls = sorted(work.glob("*.xls"))[0]
    use_angles = angles[: args.max_cases or None]
    stats = validate_deck(work / "conf.luwpf", xls, variant=args.variant,
                          angles=use_angles)
    # the other construction variant for context (the shipped STL is one of
    # the two city configurations; the non-matching variant should score
    # visibly worse — a built-in sanity check on the geometry pairing)
    other = "before" if args.variant == "after" else "after"
    stats_other = validate_deck(work / "conf.luwpf", xls, variant=other,
                                angles=use_angles, make_figure=False)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        "cell_m": args.cell, "steps": args.steps, "avg": args.avg,
        "stride": args.stride, "storage": args.storage, "vk": args.vk,
        "vk_stride": args.vk_stride,
        "ground_z0": args.z0, "building_z0": args.building_z0,
        "angles": {str(k): v for k, v in stats["angles"].items()},
        "overall": stats["overall"],
        f"overall_{other}_variant": stats_other["overall"],
        "u_ref": stats["u_ref"],
        "solve_seconds": solve_s,
        "timing": [r.timing for r in results],
    }
    (out_dir / "casee_validation.json").write_text(
        json.dumps(payload, indent=1))
    for name in (f"aij_casee_{args.variant}.png",
                 f"aij_casee_map_{args.variant}.png"):
        p = work / "RESULTS" / name
        if p.exists():
            shutil.copy(p, out_dir / name)
    print(json.dumps(payload["overall"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
