#!/bin/bash
# The port's twin of tools/run_v4_gate_sweep.sh: the discriminating-gate
# sweep on the v4 hard corpus, the same rows through the port's quality gate
# (cp2_tpu_torch/tools/quality_gate.py, the JAX tool's flags), on the card.
#
# One shared CP2 pretrain (u1600 pool, 60 epochs, seed 0) feeds every row;
# finetune-seed replicates (seed 1) reuse it via --pretrain_seed 0, the same
# shape as the reference's seed sweeps (scripts/polyp.sh finetunes seeds 0-2
# from one pretrain run).  Scratch controls are per-(ratio, seed).
#
# Usage: bash cp2_tpu_torch/tools/run_v4_gate_sweep.sh [ratio ...]   (default: 1.0 0.3 0.1)
set -e
cd "$(dirname "$0")/../.."
export PYTHONPATH=$PWD:$PYTHONPATH
ROOT=/tmp/syn_corpus_v4
LOG=/tmp/quality_gate_torch_v4
RATIOS=${@:-1.0 0.3 0.1}
for ratio in $RATIOS; do
  for seed in 0 1; do
    echo "=== v4 gate ratio=$ratio seed=$seed ==="
    python -m cp2_tpu_torch.tools.quality_gate \
      --root "$ROOT" --corpus_version 4 --n_unlabeled 1600 \
      --log_dir "$LOG" --train_ratio "$ratio" \
      --seed "$seed" --pretrain_seed 0 --reuse_pretrain
  done
done
