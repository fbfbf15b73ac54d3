#!/bin/bash
# Twin of scripts/dist_train.sh (the reference's tools/dist_train.sh, a
# torch.distributed launch): the iteration CLI on every visible card,
# through launch.sh. Usage: dist_train.sh CONFIG [iter_train flags...]
CONFIG=$1
shift
source "$(dirname "${BASH_SOURCE[0]}")/launch.sh"
launch cp2_tpu_torch.train.iter_train "$CONFIG" "$@"
