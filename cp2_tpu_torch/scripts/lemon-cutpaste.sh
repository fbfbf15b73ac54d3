#!/bin/bash
# The port's twin of scripts/lemon-cutpaste.sh: the same invocations, on the card.
# CutPaste/mirror pretext on the lemon defect data, then lemon finetune
# (reference scripts/lemon-cutpaste.sh:24-70). The reference script is
# rotted: it passes --backbone_type 'UNET_ENCODER_ONLY' to
# mirror_pretrain.py, which has no such flag (reference
# mirror_pretrain.py:21-85) — argparse dies before training. The runnable
# spelling of its intent, kept here: mirror pretrain with the lemon
# geometry/patch laws (--lemon_data forces 544x1024 + tiny patch areas,
# mirror_pretrain.py:74-80), variant NONE, batch 16, then a MIRROR-type
# lemon finetune from the saved segmentor.
source "$(dirname "$0")/common.sh"
IMG_DIR="${IMG_DIR:?}"; MASK_DIR="${MASK_DIR:?}"
preflight
mirror --run_id cutpaste-lemon --data_dirs "$DATA_DIR" --lemon_data \
  --variant NONE --epochs "${EPOCHS:-200}" --batch-size "${BATCH:-16}"
finetune --run_id cutpaste-lemon-ft --img_dirs "$IMG_DIR" \
  --mask_dirs "$MASK_DIR" --lemon_data --train_data_ratio 1.0 --seed 0 \
  --pretrain_type MIRROR --pretrain_path "$LOG_DIR/cutpaste-lemon"
