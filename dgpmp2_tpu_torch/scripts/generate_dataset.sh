#!/usr/bin/env bash
# Generate a forest-family training dataset with GPMP2-expert trajectories
# on the card (the port's counterpart of scripts/generate_dataset.sh).
# Usage: generate_dataset.sh [OUT [ARGS...]]; ARGS go to
# dgpmp2_tpu_torch.data.generate after the defaults (the last of a flag
# wins, e.g. --device cpu --num_train 4).
set -euo pipefail
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
export PYTHONPATH="$(dirname "$(dirname "$HERE")")${PYTHONPATH:+:$PYTHONPATH}"
OUT=${1:-data/forest}
shift $(( $# < 1 ? $# : 1 ))
"${PYTHON:-python3}" -m dgpmp2_tpu_torch.data.generate --out_folder "$OUT" \
  --dataset_type forest --num_train 100 --num_test 20 --probs_per_env 2 \
  --im_size 128 --seed_val 0 "$@"
