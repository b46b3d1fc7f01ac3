#!/usr/bin/env bash
# Train the trajectory-initializer network on the card (the port's
# counterpart of scripts/train_init_network.sh).
# Usage: train_init_network.sh [DATA [OUT [ARGS...]]]; ARGS go to
# dgpmp2_tpu_torch.learn.train_initializer after the defaults.
set -euo pipefail
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
export PYTHONPATH="$(dirname "$(dirname "$HERE")")${PYTHONPATH:+:$PYTHONPATH}"
DATA=${1:-data/forest}
OUT=${2:-runs/init}
shift $(( $# < 2 ? $# : 2 ))
"${PYTHON:-python3}" -m dgpmp2_tpu_torch.learn.train_initializer \
  --dataset_folders "$DATA" --out_folder "$OUT" --epochs 20 "$@"
