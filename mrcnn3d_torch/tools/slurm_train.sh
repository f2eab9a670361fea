#!/usr/bin/env bash
# Training under Slurm: one srun task running the port's training CLI
# (reference tools/slurm_train.sh; the JAX package's tools/slurm_train.sh).
#
# Usage: mrcnn3d_torch/tools/slurm_train.sh <partition> <job_name> <config> [train args...]
set -euo pipefail
PARTITION=$1
JOB_NAME=$2
CONFIG=$3
shift 3
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
srun -p "$PARTITION" --job-name="$JOB_NAME" --kill-on-bad-exit=1 \
    python -m mrcnn3d_torch.tools.train "$CONFIG" "$@"
