#!/bin/bash
# scripts/train_matterport.sh on the PyTorch port: the paper's recipe, on
# every visible GPU (--batch is per GPU).  Arguments are appended to the
# command: --gpus 1, --remat, --compute_dtype bfloat16, --device cpu.
export MATTERPORT_PATH=${MATTERPORT_PATH:-matterport}

EXPNAME=matterport

python -m rel_pose_tpu_torch.cli.train --name ${EXPNAME} --batch=6 \
        --lr=5e-4 --fusion_transformer --transformer_depth 6 \
        --w_tr 10 --w_rot 10 --steps 120000 \
        --datapath=$MATTERPORT_PATH --dataset matterport "$@"
