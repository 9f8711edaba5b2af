"""InteriorNet / StreetLearn rotation evaluation, on one GPU or sharded
over ranks (under torchrun, as ``cli.test_matterport``).

    python -m rel_pose_tpu_torch.cli.test_streetlearn_interiornet \\
        --exp exp --datapath <root> --dataset interiornet \\
        --ckpt model.ckpt --fusion_transformer --transformer_depth 6

Counterpart of the JAX package's ``test_streetlearn_interiornet.py`` with
the same flags plus ``--device`` (``cuda``, the default, or ``cpu``).  It
reads the first 1,000 pairs, sorted, of the metadata file its dataset and
``--streetlearn_interiornet_type`` select (``T``: the translation set;
every other type the rotation set, as in the JAX CLI), feeds the images at
their native resolution (no pre-resize, no reduced decode; the decode
cache ``RELPOSE_DECODE_CACHE_MB`` applies) through one
``PosePredictor(batch_size=--batch)`` from a ``.pth`` or a ``.ckpt``, and
takes the ground truth from the viewpoints
(``geom.quaternion.relative_rotation_from_viewpoints``,
``matrix_to_quat``).  Geodesic errors in degrees, bucketed by the ground
truth's angle ("overlap large" under 45 degrees, "overlap small" 45-90,
the rest dropped), go to ``output/<exp>/<set>_test/{results.txt,
all_rotation_err_degrees.csv, all_gt_rot_degrees.csv}`` under the working
directory; the metric's geometry runs in float32, as the JAX CLI's does.
Under torchrun each rank evaluates ``items[rank::world]`` of those pairs
and rank 0 writes the gathered rows' metrics (``cli._eval``).
"""

import argparse
import os
import sys

import numpy as np
import torch

from .. import parallel
from ..config import model_config_from_args
from ..data.base import image_read_cached
from ..geom.quaternion import (geodesic_angle_from_matrices, matrix_to_quat,
                               quat_to_matrix,
                               relative_rotation_from_viewpoints)
from ..infer import INTERIORNET_STREETLEARN_INTRINSICS, PosePredictor
from ._eval import (DecodePipeline, add_eval_flags, gather_predictions,
                    init_eval_world, resolve_device, shard, write_results)

PROG = "python -m rel_pose_tpu_torch.cli.test_streetlearn_interiornet"
MAX_PAIRS = 1000


def _geodesic(m1, m2):
    return geodesic_angle_from_matrices(torch.from_numpy(m1),
                                        torch.from_numpy(m2)).numpy()


def evaluation_metric_rotation(predict_rotation, gt_rotation, save_folder):
    """Rotation matrices ``(N, 3, 3)`` float32 -> the errors in degrees of
    the two buckets (``test_streetlearn_interiornet.py:28-51``); the
    errors and ground-truth angles under 90 degrees go to two CSVs."""
    geodesic_err = _geodesic(predict_rotation, gt_rotation) / np.pi * 180
    gt_distance = _geodesic(
        gt_rotation,
        np.broadcast_to(np.eye(3, dtype=np.float32),
                        gt_rotation.shape).copy())

    large = geodesic_err[gt_distance < (np.pi / 4)]
    small = geodesic_err[(gt_distance >= np.pi / 4)
                         & (gt_distance < np.pi / 2)]

    all_err = geodesic_err[gt_distance < (np.pi / 2)].astype(np.float32)
    all_gt = (gt_distance[gt_distance < (np.pi / 2)] / np.pi * 180).astype(
        np.float32)
    np.savetxt(os.path.join(save_folder, "all_rotation_err_degrees.csv"),
               all_err, delimiter=",", fmt="%1.5f")
    np.savetxt(os.path.join(save_folder, "all_gt_rot_degrees.csv"),
               all_gt, delimiter=",", fmt="%1.5f")
    return {
        "rotation_geodesic_error_overlap_large": large,
        "rotation_geodesic_error_overlap_small": small,
    }


def eval_camera(predictions, save_folder):
    """W-last quaternions -> normalized in float64, matrices in float32 ->
    each bucket's mean, median and share within 10 degrees
    (``test_streetlearn_interiornet.py:54-75``)."""
    pred = np.asarray(predictions["camera"]["preds"]["rot"], dtype=np.float64)
    gt = np.asarray(predictions["camera"]["gts"]["rot"], dtype=np.float64)

    def matrices(q):
        q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
        return quat_to_matrix(torch.from_numpy(q)).numpy()

    res_error = evaluation_metric_rotation(matrices(pred), matrices(gt),
                                           save_folder)
    all_res = {}
    for k, v in res_error.items():
        v = v.reshape(-1)
        if v.size == 0:
            continue
        all_res.update({
            k + "/mean": np.mean(v),
            k + "/median": np.median(v),
            k + "/10deg": np.true_divide((v <= 10).sum(), v.shape[0]),
        })
    return all_res


def select_metadata(dataset, kind):
    """(metadata file under the data root, output folder, image directory
    name) of ``test_streetlearn_interiornet.py:107-125``: only type ``T``
    picks the translation set; StreetLearn's T images are under
    ``streetlearn_2016``."""
    if dataset == "interiornet":
        if kind == "T":
            return ("metadata/interiornetT/test_pair_translation.npy",
                    "interiornetT_test", dataset)
        return ("metadata/interiornet/test_pair_rotation.npy",
                "interiornet_test", dataset)
    if kind == "T":
        return ("metadata/streetlearnT/test_pair_translation.npy",
                "streetlearnT_test", "streetlearn_2016")
    return ("metadata/streetlearn/test_pair_rotation.npy",
            "streetlearn_test", dataset)


def ground_truth(rec):
    """The W-last quaternion of a pair's relative rotation, float32."""
    return matrix_to_quat(relative_rotation_from_viewpoints(
        rec["img1"]["x"], rec["img1"]["y"], rec["img2"]["x"],
        rec["img2"]["y"]))


def build_parser():
    parser = argparse.ArgumentParser(prog=PROG)
    parser.add_argument("--dataset", default="interiornet",
                        choices=("interiornet", "streetlearn"))
    parser.add_argument("--streetlearn_interiornet_type", default="",
                        choices=("", "nooverlap", "T", "nooverlapT"))
    return add_eval_flags(parser)


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = model_config_from_args(args)
    device = init_eval_world(resolve_device(args.device, PROG),
                             cfg.fusion_transformer)

    meta, output_folder, image_dir = select_metadata(
        args.dataset, args.streetlearn_interiornet_type)
    dset = np.load(os.path.join(args.datapath, meta), allow_pickle=True)
    dset = np.array(dset, ndmin=1)[0]
    print("performing evaluation on %s set using model %s"
          % (output_folder, args.ckpt))
    out_dir = os.path.join("output", args.exp, output_folder)
    if parallel.is_main():
        os.makedirs(out_dir, exist_ok=True)

    predictor = PosePredictor.from_checkpoint(
        args.ckpt, cfg, device=device,
        intrinsics=INTERIORNET_STREETLEARN_INTRINSICS, batch_size=args.batch)
    items = shard(sorted(dset.items())[:MAX_PAIRS])

    def load_pair(item):
        _, rec = item
        imgs = [image_read_cached(os.path.join(args.datapath, "data",
                                               image_dir, rec[k]["path"]))
                for k in ("img1", "img2")]
        return np.ascontiguousarray(np.stack(imgs).transpose(0, 3, 1, 2))

    predictions = {"camera": {"preds": {"tran": [], "rot": []},
                              "gts": {"tran": [], "rot": []}}}
    pipeline = DecodePipeline(items, load_pair, args.batch,
                              args.decode_workers)
    for chunk, images in pipeline:
        poses = predictor.predict_batch(images)[:, 1]
        pipeline.tick()
        for (_, rec), pose in zip(chunk, poses):
            predictions["camera"]["gts"]["tran"].append(np.zeros(3))
            predictions["camera"]["gts"]["rot"].append(ground_truth(rec))
            predictions["camera"]["preds"]["tran"].append(pose[:3])
            predictions["camera"]["preds"]["rot"].append(pose[3:])

    predictions = gather_predictions(predictions)
    if parallel.is_main():
        write_results(eval_camera(predictions, out_dir), out_dir)
        print(pipeline.report(device))
    parallel.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
