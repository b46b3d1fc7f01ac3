#!/usr/bin/env bash
# Evaluate a trained planner on the validation split on the card (the
# port's counterpart of scripts/valid_planner.sh); writes
# MODEL/results.yaml.
# Usage: valid_planner.sh [DATA [MODEL [ARGS...]]]; ARGS go to
# dgpmp2_tpu_torch.learn.test_planner after the defaults.
set -euo pipefail
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
export PYTHONPATH="$(dirname "$(dirname "$HERE")")${PYTHONPATH:+:$PYTHONPATH}"
CFG="$(dirname "$HERE")/configs"
DATA=${1:-data/forest}
MODEL=${2:-runs/exp1}
shift $(( $# < 2 ? $# : 2 ))
"${PYTHON:-python3}" -m dgpmp2_tpu_torch.learn.test_planner \
  --dataset_folders "$DATA" --model_folder "$MODEL" \
  --out_file "$MODEL/results.yaml" \
  --plan_param_file "$CFG/gpmp2_2d_params.yaml" \
  --robot_param_file "$CFG/robot_2d.yaml" \
  --env_param_file "$CFG/env_2d_params.yaml" \
  --learn_param_file "$CFG/learn_params.yaml" "$@"
