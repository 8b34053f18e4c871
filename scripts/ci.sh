#!/usr/bin/env bash
# CI recipe: fast-tier tests on the CPU, and the GPU smoke on a card.
#
#   1. fast test tier  (pytest -m "not slow"; virtual 8-device CPU mesh)
#   2. slow tier       (app-level + goldens) when CI_FULL=1 or --full
#   3. multi-device dry run on the CPU mesh
#   4. --gpu: python chip_smoke.py — the main path on one NVIDIA GPU,
#      compiled for the card and checked against the references.
#
# Usage: scripts/ci.sh [--full] [--gpu]
set -euo pipefail
cd "$(dirname "$0")/.."

FULL=${CI_FULL:-0}
GPU=0
for a in "$@"; do
  [ "$a" = "--full" ] && FULL=1
  [ "$a" = "--gpu" ] && GPU=1
done

echo "== fast test tier =="
python -m pytest tests/ -m "not slow" -q

if [ "$FULL" = "1" ]; then
  echo "== slow tier (app + goldens + multihost) =="
  python -m pytest tests/ -m slow -q
fi

echo "== multi-device dry run =="
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python __graft_entry__.py

if [ "$GPU" = "1" ]; then
  echo "== GPU smoke =="
  python chip_smoke.py
fi

echo "CI OK"
