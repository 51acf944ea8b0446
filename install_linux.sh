#!/usr/bin/env bash
# LatticeUrbanWind-TPU installer: runs the staged scripts in installer/ in
# numeric-prefix order and reports a summary.  (reference: install_linux.sh —
# same staged contract, re-targeted at the JAX stack: env detection,
# PATH setup, dependency check, native-helper compile, solver smoke test.)
set -u -o pipefail

SCRIPT_DIR=$(cd "$(dirname "$0")" && pwd)
INSTALLER_DIR="$SCRIPT_DIR/installer"
[ -d "$INSTALLER_DIR" ] || { echo "missing $INSTALLER_DIR"; exit 1; }

SUCC=(); FAIL=()
for f in $(ls "$INSTALLER_DIR"/[0-9]*_*.sh | sort -n); do
  echo "=== $(basename "$f") ==="
  if bash "$f"; then SUCC+=("$(basename "$f")"); else FAIL+=("$(basename "$f")"); fi
done

echo
echo "---- install summary ----"
for s in "${SUCC[@]:-}"; do [ -n "$s" ] && echo "  OK    $s"; done
for s in "${FAIL[@]:-}"; do [ -n "$s" ] && echo "  FAIL  $s"; done
[ "${#FAIL[@]}" -eq 0 ]
