#!/usr/bin/env bash
# Data-parallel training on N cards of one host: N processes under
# torchrun, one a card, joined by NCCL (reference tools/dist_train.sh).
#
# Usage: mrcnn3d_torch/tools/dist_train.sh <config> <N> [train args...]
#   e.g. mrcnn3d_torch/tools/dist_train.sh configs/mask_rcnn_3d_2scales.py 4 --validate
# PORT (default 29500) sets the rendezvous port on localhost.
set -euo pipefail
CONFIG=$1
GPUS=$2
shift 2
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec torchrun --nproc_per_node="$GPUS" --master_port="${PORT:-29500}" \
    -m mrcnn3d_torch.tools.train "$CONFIG" --launcher pytorch "$@"
