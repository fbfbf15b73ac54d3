#!/bin/bash
# The port's twin of scripts/combined.sh: the same invocations, on the card.
# Multi-dataset multi-card pretrain (reference scripts/10-04-combined.sh):
# combined polyp+lemon corpora, data-parallel over every visible card
# (launch.sh; -b is the global batch).
source "$(dirname "$0")/common.sh"
DATA_DIR2="${DATA_DIR2:?second dataset directory}"
preflight
pretrain --run_id cp2-combined --data_dirs "$DATA_DIR" "$DATA_DIR2" \
  --pretrain_type CP2 --epochs "${EPOCHS:-200}" -b "${BATCH:-256}" --cap_queue
