#!/usr/bin/env bash
# Multi-machine data-parallel training of the PyTorch port (counterpart of
# train_multi_nodes.sh, which launches the JAX package; the reference ran 2
# machines x 4 GPUs over NCCL). Every machine starts one process per local
# card; machine 0 serves the rendezvous at MASTER_ADDR.
#
# Usage (run on EVERY machine):
#   MASTER_ADDR=10.0.0.2:9876 NUM_HOSTS=2 HOST_ID=<0|1> [NUM_GPUS=8] \
#     ./train_multi_nodes_torch.sh configs/fcos/fcos_R_50_FPN_1x.yaml [KEY VALUE ...]
#
# NUM_GPUS defaults to the cards nvidia-smi lists. SOLVER.IMS_PER_BATCH is
# the global batch: it must divide by NUM_HOSTS x NUM_GPUS.

set -euo pipefail

CONFIG=${1:?usage: train_multi_nodes_torch.sh <config> [KEY VALUE ...]}
shift

: "${MASTER_ADDR:?set MASTER_ADDR=host:port of machine 0}"
NUM_HOSTS=${NUM_HOSTS:-1}
HOST_ID=${HOST_ID:-0}
NUM_GPUS=${NUM_GPUS:-$(nvidia-smi --query-gpu=name --format=csv,noheader | wc -l)}

exec python train_net_torch.py --config-file "$CONFIG" \
  --num-gpus "$NUM_GPUS" --num-machines "$NUM_HOSTS" --machine-rank "$HOST_ID" \
  --dist-url "tcp://$MASTER_ADDR" "$@"
