#!/bin/bash
# The port's twin of scripts/same-foreground.sh: the same invocations, on the card.
# Same-foreground ablation (reference scripts/10-12-same.sh): pretrain the
# four SSL families on Kvasir, then finetune-sweep ratios {0.3, 1} x seeds
# {0,1,2}. NOTE the reference script is rotted against its own intent: it
# never passes --same_foreground (the flag it was named for, reference
# main.py:80, used at main.py:583 to feed BOTH background streams the same
# foreground index). This driver encodes the intended experiment — the flag
# is passed (cp2_tpu_torch/train/pretrain.py:109,442).
source "$(dirname "$0")/common.sh"
IMG_DIR="${IMG_DIR:?}"; MASK_DIR="${MASK_DIR:?}"
preflight
for pt in CP2 MOCO BYOL DENSECL; do
  # The JAX driver names no --config, so its MOCO and BYOL runs take
  # config_pretrain.py, whose 128-d contrast head both packages' SSLEncoder
  # refuses beside a 256-d MoCo/BYOL embedding: those two cannot start. The
  # twin passes config_moco.py for them, as ablation.sh does for the same
  # two variants; the other invocations are the JAX driver's.
  cfg=()
  case "$pt" in MOCO|BYOL) cfg=(--config "$REPO/cp2_tpu_torch/configs/config_moco.py") ;; esac
  pretrain --run_id "same-fg-${pt}" --data_dirs "$DATA_DIR" \
    --pretrain_type "$pt" --same_foreground \
    --foreground_min 0.5 --foreground_max 0.8 \
    --epochs "${EPOCHS:-200}" -b "${BATCH:-32}" --cap_queue ${cfg[@]+"${cfg[@]}"}
  for ratio in 0.3 1.0; do
    for seed in 0 1 2; do
      finetune --run_id "same-fg-${pt}-r${ratio}-s${seed}" \
        --img_dirs "$IMG_DIR" --mask_dirs "$MASK_DIR" \
        --train_data_ratio "$ratio" --seed "$seed" \
        --pretrain_type "$pt" --pretrain_path "$LOG_DIR/same-fg-${pt}"
    done
  done
done
