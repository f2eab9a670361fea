#!/usr/bin/env bash
# Evaluation under Slurm: one srun task running the port's test CLI
# (reference tools/slurm_test.sh; the JAX package's tools/slurm_test.sh).
#
# Usage: mrcnn3d_torch/tools/slurm_test.sh <partition> <job_name> <config> <checkpoint> [test args...]
set -euo pipefail
PARTITION=$1
JOB_NAME=$2
CONFIG=$3
CHECKPOINT=$4
shift 4
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
srun -p "$PARTITION" --job-name="$JOB_NAME" --kill-on-bad-exit=1 \
    python -m mrcnn3d_torch.tools.test "$CONFIG" "$CHECKPOINT" "$@"
