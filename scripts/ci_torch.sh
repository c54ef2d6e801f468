#!/usr/bin/env bash
# The PyTorch port's CPU gates (scripts/ci.sh runs the JAX reference's).
# Runs on the CPU; the card's gates are chip_smoke.py's.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

# parity of every port module against the reference (cuda-marked tests
# skip without a card)
echo "[ci_torch] port tests"
python -m pytest -q tests/test_torch_*.py "$@"

# the B1/B2 launch autotuner's smoke sweep (proxy scores off the card)
echo "[ci_torch] kernel autotuner (smoke sweep)"
python -m repro_torch.kernels.autotune --smoke --device cpu

# the PS runtime's Table 1 smoke and its three fault scenarios, against
# src/repro_torch/benchmarks/ps_baseline.json
echo "[ci_torch] PS-runtime speedup gate and scenarios (smoke)"
python -m repro_torch.benchmarks.speedup --smoke --device cpu
for scenario in churn lossy server_crash; do
    python -m repro_torch.benchmarks.speedup --scenario "$scenario" \
        --smoke --device cpu
done

# the cost counter over the smoke programs on the meta device, and its
# roofline table
echo "[ci_torch] cost report (smoke)"
python -m repro_torch.analysis.report

# telemetry inert: z, makespan, metrics and fold logs bitwise with
# telemetry on and off, and its exports valid
echo "[ci_torch] telemetry inertness + schema gate"
python scripts/check_telemetry_inert_torch.py
