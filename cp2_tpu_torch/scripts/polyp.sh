#!/bin/bash
# The port's twin of scripts/polyp.sh: the same invocations, on the card.
# CP2 pretrain on polyp images + finetune sweep (reference scripts/polyp.sh).
source "$(dirname "$0")/common.sh"
IMG_DIR="${IMG_DIR:?path to finetune images}"; MASK_DIR="${MASK_DIR:?path to masks}"
preflight
pretrain --run_id cp2-polyp --data_dirs "$DATA_DIR" --pretrain_type CP2 \
  --epochs "${EPOCHS:-200}" -b "${BATCH:-64}" --lr 1e-3 --optim sgd --cap_queue
finetune_sweep cp2-polyp \
  --img_dirs "$IMG_DIR" --mask_dirs "$MASK_DIR" \
  --pretrain_type CP2 --pretrain_path "$LOG_DIR/cp2-polyp"
