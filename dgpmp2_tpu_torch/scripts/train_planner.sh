#!/usr/bin/env bash
# Train the learned planner on the card (the port's counterpart of
# scripts/train_planner.sh), with the port's YAMLs beside this script.
# Usage: train_planner.sh [DATA [OUT [ARGS...]]]; ARGS go to
# dgpmp2_tpu_torch.learn.train_planner after the defaults (a later
# --learn_param_file replaces the default one).
set -euo pipefail
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
export PYTHONPATH="$(dirname "$(dirname "$HERE")")${PYTHONPATH:+:$PYTHONPATH}"
CFG="$(dirname "$HERE")/configs"
DATA=${1:-data/forest}
OUT=${2:-runs/exp1}
shift $(( $# < 2 ? $# : 2 ))
"${PYTHON:-python3}" -m dgpmp2_tpu_torch.learn.train_planner \
  --dataset_folders "$DATA" --out_folder "$OUT" \
  --plan_param_file "$CFG/gpmp2_2d_params.yaml" \
  --robot_param_file "$CFG/robot_2d.yaml" \
  --env_param_file "$CFG/env_2d_params.yaml" \
  --learn_param_file "$CFG/learn_params.yaml" "$@"
