#!/bin/bash
# scripts/train_interiornet_t.sh on the PyTorch port: the paper's recipe, on
# every visible GPU (--batch is per GPU).  Arguments are appended to the
# command: --gpus 1, --remat, --compute_dtype bfloat16, --device cpu.
export INTERIORNET_STREETLEARN_PATH=${INTERIORNET_STREETLEARN_PATH:-data}

EXPNAME=interiornet_t

python -m rel_pose_tpu_torch.cli.train --name ${EXPNAME} --batch=6 \
        --lr=5e-4 --fusion_transformer --transformer_depth 6 \
        --w_tr 10 --w_rot 10 --steps 120000 \
        --streetlearn_interiornet_type T \
        --datapath=$INTERIORNET_STREETLEARN_PATH --dataset interiornet "$@"
