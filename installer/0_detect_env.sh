#!/usr/bin/env bash
# Stage 0: environment detection (reference: installer/0_detect_env.sh).
# Probes python, JAX, and the accelerator (GPU/CPU) via the luwenv tool.
set -u
LUW_HOME=$(cd "$(dirname "$0")/.." && pwd)
echo "LUW_HOME = $LUW_HOME"
command -v python3 >/dev/null || { echo "python3 not found"; exit 1; }
python3 --version
PYTHONPATH="$LUW_HOME${PYTHONPATH:+:$PYTHONPATH}" \
  python3 -m latticeurbanwind_tpu.cli.dispatch luwenv
