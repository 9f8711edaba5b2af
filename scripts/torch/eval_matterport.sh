#!/bin/bash
# scripts/eval_matterport.sh on the PyTorch port: the paper's evaluation,
# sharded over the visible GPUs when --batch divides their count.
# Arguments are appended to the command: --batch 64, --compute_dtype
# bfloat16, --device cpu.
export MATTERPORT_PATH=${MATTERPORT_PATH:-matterport}

# TRAINED
# CKPT=output/matterport/checkpoints/120000.pth
# PRETRAINED (reference torch checkpoint, or a .ckpt of the JAX package)
CKPT=${CKPT:-pretrained_models/matterport.pth}

EXPNAME=matterport

python -m rel_pose_tpu_torch.cli.test_matterport --exp ${EXPNAME} \
        --transformer_depth 6 --fusion_transformer --ckpt $CKPT \
        --datapath=$MATTERPORT_PATH "$@"
