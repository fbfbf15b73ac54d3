#!/bin/bash
# The port's twin of scripts/imgnet-pretrained.sh: the same invocations, on the card.
# Evaluate downloaded ImageNet SSL checkpoints (reference scripts/imgnet-pretrained.sh):
# one finetune per checkpoint via the PretrainType conversion matrix.
source "$(dirname "$0")/common.sh"
IMG_DIR="${IMG_DIR:?}"; MASK_DIR="${MASK_DIR:?}"
CKPT_DIR="${CKPT_DIR:?directory of downloaded checkpoints named <TYPE>.pth}"
preflight
for ptype in DENSECL_IMGNET DINO_IMGNET BARLOWTWINS_IMGNET VICEREGL_IMGNET \
             MOCO_IMGNET PIXPRO_IMGNET BYOL_IMGNET CP2_IMGNET MOSREP_IMGNET CLOVE_IMGNET; do
  ckpt="$CKPT_DIR/${ptype}.pth"
  [ -f "$ckpt" ] || { echo "skip $ptype (no $ckpt)"; continue; }
  finetune_sweep "imgnet-${ptype}" --img_dirs "$IMG_DIR" --mask_dirs "$MASK_DIR" \
    --pretrain_type "$ptype" --pretrain_path "$ckpt" \
    --config "$REPO/cp2_tpu_torch/configs/config_finetune_moco.py"
done
