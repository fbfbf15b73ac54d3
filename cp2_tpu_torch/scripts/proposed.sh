#!/bin/bash
# The port's twin of scripts/proposed.sh: the same invocations, on the card.
# PROPOSED pixel/region-correspondence variant (reference scripts/10-14-proposed.sh):
# CP2 skeleton with SAM region ids and up-weighted pixel correspondences.
source "$(dirname "$0")/common.sh"
preflight
pretrain --run_id proposed --data_dirs "$DATA_DIR" --pretrain_type PROPOSED \
  --mapping_type PIXEL_REGION_ID --lmbd_pixel_corr_weight 10 \
  --lmbd_region_corr_weight 1 --lmbd_not_corr_weight 0 \
  --epochs "${EPOCHS:-200}" -b "${BATCH:-64}" --cap_queue
