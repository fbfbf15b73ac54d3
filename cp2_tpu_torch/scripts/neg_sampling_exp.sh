#!/bin/bash
# The port's twin of scripts/neg_sampling_exp.sh: the same invocations, on the card.
# Dense-negative post-processing sweep (reference scripts/neg_sampling_exp.sh):
# NegativeType x scale on the PROPOSED pipeline.
source "$(dirname "$0")/common.sh"
preflight
for neg in FIXED AVERAGE MEDIAN HARD; do
  pretrain --run_id "neg-${neg}" --data_dirs "$DATA_DIR" \
    --pretrain_type PROPOSED --negative_type "$neg" --negative_scale 2 \
    --epochs "${EPOCHS:-100}" -b "${BATCH:-64}" --cap_queue
done
