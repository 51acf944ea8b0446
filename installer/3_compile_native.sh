#!/usr/bin/env bash
# Stage 3: native helper build (reference: installer/3_compile_cfdcore.sh).
# The compute core is JIT-compiled by XLA at run time; the native C++
# helpers (voxelizer, VTK encoder) are built here ahead of time.
set -u
LUW_HOME=$(cd "$(dirname "$0")/.." && pwd)
PYTHONPATH="$LUW_HOME${PYTHONPATH:+:$PYTHONPATH}" python3 - <<'PY'
from latticeurbanwind_tpu.utils.native import load
lib = load()
print("native helpers:", "built OK" if lib is not None else "unavailable (pure-python fallbacks active)")
PY
