#!/bin/bash
# The port's twin of scripts/ablation.sh: the same invocations, on the card.
# MoCo / BYOL / CP2 image-level ablation matrix (reference scripts/10-05-ablation.sh).
source "$(dirname "$0")/common.sh"
preflight
for variant in MOCO BYOL CP2; do
  cfg="$REPO/cp2_tpu_torch/configs/config_moco.py"
  [ "$variant" = CP2 ] && cfg="$REPO/cp2_tpu_torch/configs/config_pretrain.py"
  pretrain --run_id "ablate-${variant}" --data_dirs "$DATA_DIR" \
    --pretrain_type "$variant" --config "$cfg" \
    --epochs "${EPOCHS:-100}" -b "${BATCH:-64}" --cap_queue
done
