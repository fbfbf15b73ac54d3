#!/bin/bash
# The port's twin of scripts/densecl.sh: the same invocations, on the card.
# DenseCL ablation (reference scripts/10-11-densecl.sh).
source "$(dirname "$0")/common.sh"
preflight
pretrain --run_id densecl --data_dirs "$DATA_DIR" --pretrain_type DENSECL \
  --epochs "${EPOCHS:-200}" -b "${BATCH:-64}" --lr 1e-3 --cap_queue \
  --config "$REPO/cp2_tpu_torch/configs/config_moco.py"
