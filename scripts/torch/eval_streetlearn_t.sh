#!/bin/bash
# scripts/eval_streetlearn_t.sh on the PyTorch port: the paper's evaluation,
# sharded over the visible GPUs when --batch divides their count.
# Arguments are appended to the command: --batch 64, --compute_dtype
# bfloat16, --device cpu.
export INTERIORNET_STREETLEARN_PATH=${INTERIORNET_STREETLEARN_PATH:-data}

CKPT=${CKPT:-pretrained_models/streetlearn_t.pth}
EXPNAME=streetlearn_t

python -m rel_pose_tpu_torch.cli.test_streetlearn_interiornet \
        --exp ${EXPNAME} --transformer_depth 6 \
        --fusion_transformer --ckpt $CKPT \
        --datapath=$INTERIORNET_STREETLEARN_PATH --dataset streetlearn \
        --streetlearn_interiornet_type T "$@"
