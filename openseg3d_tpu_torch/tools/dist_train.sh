#!/usr/bin/env bash
# Data-parallel training on one or more hosts: one process per GPU under
# torchrun, NCCL between them (openseg3d_tpu_torch/parallel/dist.py).
#
# Usage on each host (GPUS processes there, NNODES hosts in all):
#   GPUS=8 NNODES=2 NODE_RANK=0 MASTER_ADDR=host0 MASTER_PORT=29500 \
#     bash openseg3d_tpu_torch/tools/dist_train.sh \
#     --cfg_file configs/waymo_one_sweep.yaml --data_dir /data/waymo \
#     --save_dir runs/exp1 [train.py args...]
# --batch_size is per process; the global batch is batch_size x GPUS x NNODES.
set -euo pipefail

GPUS=${GPUS:-1}
NNODES=${NNODES:-1}
NODE_RANK=${NODE_RANK:-0}
MASTER_ADDR=${MASTER_ADDR:-127.0.0.1}
MASTER_PORT=${MASTER_PORT:-29500}

# the repository root on the path, so that -m finds the package from any directory
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
exec torchrun --nnodes "$NNODES" --node_rank "$NODE_RANK" --nproc_per_node "$GPUS" \
    --master_addr "$MASTER_ADDR" --master_port "$MASTER_PORT" \
    -m openseg3d_tpu_torch.tools.train --launcher pytorch "$@"
