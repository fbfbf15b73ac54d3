#!/bin/bash
# The port's twin of scripts/sym-coord.sh: the same invocations, on the card.
# Symmetric + coordinate-blended PROPOSED_V2 (reference scripts/10-17-sym-coord.sh,
# 10-18-coord.sh): DenseCL machinery with ground-truth coordinate positives.
source "$(dirname "$0")/common.sh"
preflight
for lmbd in 0 0.5 1; do
  pretrain --run_id "sym-coord-l${lmbd}" --data_dirs "$DATA_DIR" \
    --pretrain_type PROPOSED_V2 --use_symmetrical_loss --use_predictor \
    --lmbd_coordinate "$lmbd" --lmbd_cp2_dense_loss 0.5 \
    --dense_logits_temp 0.2 --instance_logits_temp 0.2 \
    --epochs "${EPOCHS:-200}" -b "${BATCH:-64}" --cap_queue
done
