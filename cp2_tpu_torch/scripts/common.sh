#!/bin/bash
# Shared experiment-driver plumbing of the port, the twin of
# scripts/common.sh (the reference's preflight + sweep pattern, e.g.
# scripts/polyp.sh:16): the same shell functions and dry-run mode, each CLI
# started on the card by launch.sh.
set -euo pipefail
source "$(dirname "${BASH_SOURCE[0]}")/launch.sh"
LOG_DIR="${LOG_DIR:-/tmp/cp2_tpu_torch_logs}"
DATA_DIR="${DATA_DIR:?set DATA_DIR to the pretrain image directory}"
mkdir -p "$LOG_DIR"

preflight() {
  # every experiment checks the card first (reference scripts/polyp.sh:16):
  # the device, the kernels' build, every kernel against its plain version
  # at every shape the drivers give it, and a narrow step on the card
  # against the CPU (chip_smoke.py phases 1-4). The JAX scripts run pytest
  # here; the port's parity tests import JAX, which the card's machine lacks.
  python3 "$REPO/chip_smoke.py" --preflight
}

preflight_full() {
  # every phase of chip_smoke.py, the CLIs at full width included
  python3 "$REPO/chip_smoke.py"
}

pretrain() { launch cp2_tpu_torch.train.pretrain --log_dir "$LOG_DIR" "$@"; }
finetune() { launch cp2_tpu_torch.train.finetune --log_dir "$LOG_DIR" "$@"; }
mirror()   { launch cp2_tpu_torch.train.mirror_pretrain --log_dir "$LOG_DIR" "$@"; }

if [ -n "${CP2_SCRIPT_DRYRUN:-}" ]; then
  # Flag-rot guard mode (tests/test_torch_scripts.py): echo every CLI
  # invocation instead of running it, in the JAX scripts' format, so the
  # test can compare the two lists and feed each flag list through the
  # port's argparse + hparam-validation web.
  preflight() { :; }
  preflight_full() { :; }
  pretrain() { printf 'PRETRAIN\t--log_dir %s %s\n' "$LOG_DIR" "$*"; }
  finetune() { printf 'FINETUNE\t--log_dir %s %s\n' "$LOG_DIR" "$*"; }
  mirror()   { printf 'MIRROR\t--log_dir %s %s\n' "$LOG_DIR" "$*"; }
fi

finetune_sweep() {
  # ratio x seed matrix (reference sweep pattern: ratios 0.3/0.6/1, seeds 0/1/2)
  local tag="$1"; shift
  for ratio in 0.3 0.6 1.0; do
    for seed in 0 1 2; do
      finetune --run_id "${tag}-r${ratio}-s${seed}" \
        --train_data_ratio "$ratio" --seed "$seed" "$@"
    done
  done
}
