#!/bin/bash
# The port's twin of scripts/hist.sh: the same invocations, on the card.
# Histopathology (GlaS/aSMA) pipeline (reference scripts/hist.sh): CSV splits.
source "$(dirname "$0")/common.sh"
IMG_DIR="${IMG_DIR:?}"; MASK_DIR="${MASK_DIR:?}"
preflight
pretrain --run_id cp2-hist --data_dirs "$DATA_DIR" --directory_type CSV \
  --pretrain_type CP2 --epochs "${EPOCHS:-200}" -b "${BATCH:-64}" --cap_queue
finetune_sweep cp2-hist --img_dirs "$IMG_DIR" --mask_dirs "$MASK_DIR" \
  --data_split_type RANDOM --pretrain_type CP2 --pretrain_path "$LOG_DIR/cp2-hist"
