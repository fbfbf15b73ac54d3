#!/bin/bash
# The port's twin of scripts/lemon.sh: the same invocations, on the card.
# Lemon defect dataset (reference scripts/lemon.sh): 512^2 CSV layout, 12 classes.
source "$(dirname "$0")/common.sh"
IMG_DIR="${IMG_DIR:?}"; MASK_DIR="${MASK_DIR:?}"
preflight
# Reference lemon.sh:37-45 pretrains with the encoder-only U-Net backbone
# and a looser foreground range. Its literal flags are stale against its
# own code twice over: --lmbd_corr_weight no longer exists (split into
# --lmbd_{region,pixel,not}_corr_weight, main.py:75-77), 'PIXEL_REGION' is
# not a MappingType choice (main.py:67), and even the intended
# PIXEL_REGION_ID mapping is forbidden for CP2 by the assert web
# (builder.py:431-433; non-DEEPLABV3 backbones are CP2-only per :360-363).
# The only runnable spelling of the script's intent — kept here — is CP2 +
# UNET_ENCODER_ONLY + default CP2 mapping + the foreground range.
BACKBONE="${BACKBONE:-UNET_ENCODER_ONLY}"
pretrain --run_id cp2-lemon --data_dirs "$DATA_DIR" --lemon_data \
  --pretrain_type CP2 --backbone_type "$BACKBONE" \
  --pixel_ids_stride 1 --foreground_min 0.25 --foreground_max 0.5 \
  --epochs "${EPOCHS:-200}" -b "${BATCH:-32}" --cap_queue
if [ "$BACKBONE" = DEEPLABV3 ]; then
  finetune_sweep cp2-lemon --img_dirs "$IMG_DIR" --mask_dirs "$MASK_DIR" \
    --lemon_data --pretrain_type CP2 --pretrain_path "$LOG_DIR/cp2-lemon"
else
  # The reference's lemon.sh stops after pretraining; a U-Net-backbone
  # checkpoint cannot initialize the DeepLabV3 finetune segmentor (the
  # reference would silently load zero tensors via strict=False —
  # segment_network.py:92 — our finetune refuses instead). Run with
  # BACKBONE=DEEPLABV3 to pretrain a finetunable encoder and sweep.
  echo "skipping finetune sweep: $BACKBONE pretrain is not loadable into the DeepLabV3 finetune config"
fi
