#!/bin/bash
# The port's quality-gate rows that need more than one gate call on one
# pretrain (cp2_tpu_torch/tools/quality_gate.py, on the card).
#
#   u1600        the JAX package's five v1 rows with the 1600-image unlabeled
#                pool (reports/quality/quality_gate_u1600_*.json), as JAX ran
#                them: one 96-epoch pretrain (5952 steps) feeds all five.  The
#                60-epoch rows reuse it, since the gate reuses a checkpoint
#                whose epoch is at least the epochs asked for.  The ratio-1.0
#                and 0.3 rows import their scratch legs from the port's
#                pool-400 rows, as the JAX rows did from theirs.
#   seed_spread  five finetune seeds on one pretrain, CP2 leg only, at the v4
#                pool-1600 ratio-0.1 and v1 pool-400 ratio-0.3 settings, under
#                reports/quality_torch/seed_spread/<group>/.
#   v1_r0.3_groups  the v1 pool-400 ratio-0.3 setting split into finetune and
#                pretrain: the scratch leg alone at finetune seeds 0-4
#                (seed_spread/v1_r0.3_scratch/), then the CP2 leg at finetune
#                seed 0 on pretrain seeds 0-4, a pretrain of each
#                (seed_spread/v1_r0.3_pretrain_seeds/, one row per pretrain
#                seed, named ..._s0_p<seed>.json); each group's SUMMARY.md by
#                seed_group, and the corpus held to its committed digests.
#   v1_r0.3_scratch_fp32  the scratch group again with the finetunes in
#                float32 (--finetune_float32), to see whether the finetune's
#                precision moves its Dice (seed_spread/v1_r0.3_scratch_fp32/).
#
# Each corpus version has its own --root and --log_dir: the pretrain's run id
# (qg_pretrain_u<pool>_s<seed>) does not name the corpus version, so a
# checkpoint of another corpus in the same --log_dir would be reused.
#
# Usage: bash cp2_tpu_torch/tools/run_gate_rows.sh u1600|seed_spread|v1_r0.3_groups|v1_r0.3_scratch_fp32
set -e
cd "$(dirname "$0")/../.."
export PYTHONPATH=$PWD:$PYTHONPATH
WORK=work_dirs/gate_rows
OUT=reports/quality_torch
gate() { python -m cp2_tpu_torch.tools.quality_gate "$@"; }

case "$1" in
  u1600)
    V1=(--root "$WORK/syn_corpus_v1" --log_dir "$WORK/qg_v1" --n_unlabeled 1600)
    gate "${V1[@]}" --pretrain_epochs 96 --train_ratio 1.0 --seed 0 \
      --scratch_from "$OUT/quality_gate.json"
    gate "${V1[@]}" --pretrain_epochs 96 --train_ratio 0.3 --seed 0 --reuse_pretrain \
      --scratch_from "$OUT/quality_gate_r0.3_s0.json"
    gate "${V1[@]}" --pretrain_epochs 96 --train_ratio 0.1 --seed 0 --reuse_pretrain
    for seed in 1 2; do
      gate "${V1[@]}" --pretrain_epochs 60 --train_ratio 0.1 --seed "$seed" \
        --pretrain_seed 0 --reuse_pretrain
    done
    ;;
  seed_spread)
    for seed in 0 1 2 3 4; do
      gate --root "$WORK/syn_corpus_v4" --log_dir "$WORK/qg_v4" --corpus_version 4 \
        --n_unlabeled 1600 --train_ratio 0.1 --seed "$seed" --pretrain_seed 0 \
        --reuse_pretrain --skip_scratch --out "$OUT/seed_spread/v4_u1600_r0.1"
    done
    for seed in 0 1 2 3 4; do
      gate --root "$WORK/syn_corpus_v1_u0" --log_dir "$WORK/qg_v1_u0" \
        --train_ratio 0.3 --seed "$seed" --pretrain_seed 0 \
        --reuse_pretrain --skip_scratch --out "$OUT/seed_spread/v1_r0.3"
    done
    ;;
  v1_r0.3_groups)
    V1=(--root "$WORK/syn_corpus_v1_u0" --log_dir "$WORK/qg_v1_u0" --train_ratio 0.3)
    GROUP=$OUT/seed_spread/v1_r0.3_scratch
    for seed in 0 1 2 3 4; do
      gate "${V1[@]}" --seed "$seed" --scratch_only --out "$GROUP"
    done
    python -m cp2_tpu_torch.tools.seed_group "$GROUP" --out "$GROUP/SUMMARY.md"
    GROUP=$OUT/seed_spread/v1_r0.3_pretrain_seeds
    for pseed in 0 1 2 3 4; do
      # every row is named quality_gate_r0.3_s0.json: each goes to a
      # directory of its own, and seed_group gathers them into the group
      gate "${V1[@]}" --seed 0 --pretrain_seed "$pseed" --reuse_pretrain --skip_scratch \
        --out "$WORK/pretrain_seed_rows/p$pseed"
    done
    python -m cp2_tpu_torch.tools.seed_group "$WORK"/pretrain_seed_rows/p[0-4] \
      --gather "$GROUP" --out "$GROUP/SUMMARY.md"
    python -m cp2_tpu_torch.tools.synthetic_corpus --out "$WORK/syn_corpus_v1_u0" \
      --check "$OUT/corpus_v1_s0_160.json"
    ;;
  v1_r0.3_scratch_fp32)
    GROUP=$OUT/seed_spread/v1_r0.3_scratch_fp32
    for seed in 0 1 2 3 4; do
      gate --root "$WORK/syn_corpus_v1_u0" --log_dir "$WORK/qg_v1_u0_fp32" --train_ratio 0.3 \
        --seed "$seed" --scratch_only --finetune_float32 --out "$GROUP"
    done
    python -m cp2_tpu_torch.tools.seed_group "$GROUP" --out "$GROUP/SUMMARY.md"
    ;;
  *)
    echo "usage: $0 u1600|seed_spread|v1_r0.3_groups|v1_r0.3_scratch_fp32" >&2
    exit 2
    ;;
esac
