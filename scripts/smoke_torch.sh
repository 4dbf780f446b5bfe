#!/usr/bin/env bash
# Smoke test of the PyTorch/CUDA port: run its quickstart (transfer
# workers + consistent audits) under a timeout.  Exercises the
# repro_torch.api surface end to end; the quickstart asserts on torn
# reads, so a non-zero exit means real breakage.  Arguments pass through
# to the quickstart: on the card by default, `--device cpu` without one.
#
#   bash scripts/smoke_torch.sh                  # the card
#   SMOKE_BACKEND=tl2 bash scripts/smoke_torch.sh --device cpu
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${SMOKE_TIMEOUT:-120}"
BACKEND="${SMOKE_BACKEND:-multiverse}"

PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH} timeout "$TIMEOUT" \
    python -m repro_torch.examples.quickstart --backend "$BACKEND" "$@"
echo "smoke ok (backend=$BACKEND)"
