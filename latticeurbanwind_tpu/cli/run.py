"""runluw — run the solver on a deck (.luw / .luwdg / .luwpf).

Replacement for the reference's FluidX3D binary launch
(reference: bin/runluw.ps1, submit_cfd_silent.sh).  Checks the validation
gate the same way the solver does (setup.cpp:3446-3475) — refusing to run
unless `validation = pass` or --force is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="runluw", description=__doc__)
    parser.add_argument("deck", help="path to conf.luw / .luwdg / .luwpf")
    parser.add_argument("--impl", default="auto",
                        choices=["auto", "reference", "pallas"],
                        help="step tier: auto (the fused kernel on a GPU, "
                             "else jnp), reference (jnp), pallas (the fused "
                             "kernel; fails off a GPU)")
    parser.add_argument("--force", action="store_true",
                        help="skip the prerun validation gate")
    parser.add_argument("--max-cases", type=int, default=0,
                        help="limit batch modes to the first N cases")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    from ..deck import deck_mode_from_path, load_deck
    from ..run import run_deck

    deck_path = Path(args.deck).expanduser().resolve()
    mode = deck_mode_from_path(deck_path)
    deck = load_deck(deck_path)

    if mode == "luw" and not args.force:
        status = (deck.get_text("validation") or "").lower()
        if status != "pass":
            print(f"ERROR: deck validation status is '{status or 'missing'}' "
                  "(run luwval first, or pass --force)")
            return 1

    results = run_deck(deck_path, impl=args.impl, quiet=args.quiet,
                       max_cases=args.max_cases)
    total = sum(r.solver_seconds for r in results)
    print(f"runluw: {len(results)} case(s) complete, "
          f"solver time {total:.1f} s, "
          f"{sum(len(r.files) for r in results)} file(s) written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
