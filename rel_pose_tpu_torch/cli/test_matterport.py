"""Matterport test-split evaluation over every local GPU, or sharded over
ranks.

    python -m rel_pose_tpu_torch.cli.test_matterport --exp exp \\
        --datapath <root> --ckpt model.ckpt --fusion_transformer \\
        --transformer_depth 6 --batch 64
    torchrun --nproc_per_node 4 -m rel_pose_tpu_torch.cli.test_matterport ...

Counterpart of the JAX package's ``test_matterport.py`` with the same flags
plus ``--device`` (``cuda``, the default, or ``cpu``).  It reads
``<datapath>/mp3d_planercnn_json/cached_set_test.json`` (image paths with
their first 6 components dropped), predicts every pair through one
``PosePredictor(batch_size=--batch, image_size=(384, 512))``, sharded
over the local GPUs when ``--batch`` divides them (``cli._eval``), from a
``.pth`` or a ``.ckpt``, and writes ``output/<exp>/matterport_test/
{results.txt, gt_translation_magnitude_vs_error.csv,
gt_rotation_magnitude_vs_error.csv}`` under the working directory.  The
ground-truth quaternion (W first) is sign-fixed to W >= 0; the prediction
goes through ``infer.matterport_eval_pose`` (elements 3 and 6 swapped,
translation times ``DEPTH_SCALE``).  The host decodes one chunk ahead
(``cli._eval.DecodePipeline``), honouring ``RELPOSE_DECODE_REDUCE`` and
``RELPOSE_DECODE_CACHE_MB`` (``data.base``).  The last line gives the
steady-state pairs/s and the share of the loop spent waiting on decode.
Under torchrun each rank evaluates ``dset[rank::world]`` and rank 0 writes
the gathered rows' metrics (``cli._eval``).
"""

import argparse
import json
import os
import sys

import numpy as np

from .. import parallel
from ..config import model_config_from_args
from ..data.base import image_read_cached
from ..infer import MATTERPORT_INTRINSICS, matterport_eval_pose
from ._eval import (DecodePipeline, add_eval_flags, gather_predictions,
                    init_eval_world, load_predictor, resolve_device, shard,
                    write_results)

PROG = "python -m rel_pose_tpu_torch.cli.test_matterport"
OUTPUT_FOLDER = "matterport_test"


def eval_camera(predictions, exp, output_folder):
    """The metric suite of ``test_matterport.py:29-65`` (numpy, in the
    dtypes ``np.vstack`` gives): translation and rotation errors, their
    means, medians and accuracies under 1 m / 30 degrees; the per-pair
    errors against the ground truth's magnitudes go to two CSVs."""
    acc_threshold = {"tran": 1.0, "rot": 30}

    pred_tran = np.vstack(predictions["camera"]["preds"]["tran"])
    pred_rot = np.vstack(predictions["camera"]["preds"]["rot"])
    gt_tran = np.vstack(predictions["camera"]["gts"]["tran"])
    gt_rot = np.vstack(predictions["camera"]["gts"]["rot"])

    top1_error = {
        "tran": np.linalg.norm(gt_tran - pred_tran, axis=1),
        "rot": 2 * np.arccos(np.clip(np.abs(
            np.sum(pred_rot * gt_rot, axis=1)), -1.0, 1.0)) * 180 / np.pi,
    }
    top1_accuracy = {
        k: (top1_error[k] < acc_threshold[k]).sum() / len(top1_error[k])
        for k in ("tran", "rot")
    }
    camera_metrics = {
        f"top1 T err < {acc_threshold['tran']}": top1_accuracy["tran"] * 100,
        f"top1 R err < {acc_threshold['rot']}": top1_accuracy["rot"] * 100,
        "T mean err": np.mean(top1_error["tran"]),
        "R mean err": np.mean(top1_error["rot"]),
        "T median err": np.median(top1_error["tran"]),
        "R median err": np.median(top1_error["rot"]),
    }

    gt_mags = {"tran": np.linalg.norm(gt_tran, axis=1),
               "rot": 2 * np.arccos(np.clip(gt_rot[:, 0], -1, 1)) * 180 / np.pi}
    out_dir = os.path.join("output", exp, output_folder)
    np.savetxt(os.path.join(out_dir, "gt_translation_magnitude_vs_error.csv"),
               np.stack([gt_mags["tran"], top1_error["tran"]], axis=1),
               delimiter=",", fmt="%1.5f")
    np.savetxt(os.path.join(out_dir, "gt_rotation_magnitude_vs_error.csv"),
               np.stack([gt_mags["rot"], top1_error["rot"]], axis=1),
               delimiter=",", fmt="%1.5f")
    return camera_metrics


def image_path(datapath, file_name):
    """A split entry's image: its path without the first 6 components
    (``test_matterport.py:173``), under ``datapath``."""
    return os.path.join(datapath, "/".join(str(file_name).split("/")[6:]))


def ground_truth(entry):
    """(translation, W-first quaternion sign-fixed to W >= 0) of a split
    entry."""
    rotation = list(entry["rel_pose"]["rotation"])
    if rotation[0] < 0:
        rotation = [-v for v in rotation]
    return entry["rel_pose"]["position"], rotation


def build_parser():
    return add_eval_flags(argparse.ArgumentParser(prog=PROG))


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = model_config_from_args(args)
    device = init_eval_world(resolve_device(args.device, PROG),
                             cfg.fusion_transformer)

    with open(os.path.join(args.datapath,
                           "mp3d_planercnn_json/cached_set_test.json")) as f:
        dset = shard(json.load(f)["data"])
    print("performing evaluation on %s set using model %s"
          % (OUTPUT_FOLDER, args.ckpt))
    out_dir = os.path.join("output", args.exp, OUTPUT_FOLDER)
    if parallel.is_main():
        os.makedirs(out_dir, exist_ok=True)

    predictor = load_predictor(args.ckpt, cfg, device, args.batch,
                               intrinsics=MATTERPORT_INTRINSICS,
                               image_size=(384, 512))

    reduce = int(os.environ.get("RELPOSE_DECODE_REDUCE", "1"))
    if reduce > 1:
        print(f"decoding at 1/{reduce} scale (RELPOSE_DECODE_REDUCE)")

    def load_pair(entry):
        imgs = [image_read_cached(image_path(args.datapath,
                                             entry[k]["file_name"]), reduce)
                for k in ("0", "1")]
        return np.ascontiguousarray(np.stack(imgs).transpose(0, 3, 1, 2))

    predictions = {"camera": {"preds": {"tran": [], "rot": []},
                              "gts": {"tran": [], "rot": []}}}
    pipeline = DecodePipeline(dset, load_pair, args.batch,
                              args.decode_workers)
    for chunk, images in pipeline:
        poses = matterport_eval_pose(predictor.predict_batch(images)[:, 1])
        pipeline.tick()
        for entry, pose in zip(chunk, poses):
            tran, rot = ground_truth(entry)
            predictions["camera"]["gts"]["tran"].append(tran)
            predictions["camera"]["gts"]["rot"].append(rot)
            predictions["camera"]["preds"]["tran"].append(pose[:3])
            predictions["camera"]["preds"]["rot"].append(pose[3:])

    predictions = gather_predictions(predictions)
    if parallel.is_main():
        write_results(eval_camera(predictions, args.exp, OUTPUT_FOLDER),
                      out_dir)
        print(pipeline.report(device))
    parallel.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
