#!/bin/bash
# The port's launcher, sourced by common.sh and dist_train.sh. The JAX
# package's one process drives every chip of its host; here one process
# runs each card: `python -m <cli>` on one card, torchrun over N > 1 (the
# CLIs join the group torchrun's environment describes, and -b /
# --batch-size / the config's batch_size is the global batch). It counts
# the cards as torch.cuda.device_count(), which honours
# CUDA_VISIBLE_DEVICES, and never runs on the CPU.
REPO="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="$REPO:${PYTHONPATH:-}"

launch() {
  # launch <module> [args...]
  local module="$1"; shift
  local cards
  cards="$(python -c 'import torch; print(torch.cuda.device_count())')" || return 1
  case "$cards" in
    '' | *[!0-9]*) echo "launch: cannot count the cards (got '$cards')" >&2; return 1 ;;
  esac
  if [ "$cards" -lt 1 ]; then
    echo "launch: no CUDA card is visible (torch.cuda.device_count() is 0);" \
      "the port's drivers do not run on the CPU" >&2
    return 1
  fi
  if [ "$cards" -eq 1 ]; then
    python -m "$module" "$@"
  else
    torchrun --standalone --nproc_per_node "$cards" -m "$module" "$@"
  fi
}
