#!/bin/bash
# The port's twin of scripts/polyp-cutpaste.sh: the same invocations, on the card.
# CutPaste/mirror pretext on polyp data (reference scripts/polyp-cutpaste.sh).
source "$(dirname "$0")/common.sh"
preflight
mirror --run_id cutpaste-polyp --data_dirs "$DATA_DIR" \
  --epochs "${EPOCHS:-200}" --batch-size "${BATCH:-10}" --variant OUTPUT
