"""The port's demo CLI (``rel_pose_tpu_torch.cli.demo``) against the JAX
package's ``demo.py``, on the CPU.

The JAX package's seeded flagship at depth 2 is written by its
``save_checkpoint`` under two names, one containing ``matterport``; the
JAX ``demo.py`` runs once on each (a subprocess, as tests/test_cli.py runs
it), the port's ``main([..., "--device", "cpu"])`` in-process on each and
on the same weights as a port ``.pth``.  Images: a 120x160 pair of
tests/test_cli.py's Matterport tree for the Matterport branch (the 384x512
resize, its intrinsics, ``matterport_demo_pose``), a 128x128 pair for the
other (native resolution, the InteriorNet / StreetLearn intrinsics).

Each run prints the JAX script's header and 7 (Matterport) or 4 numbers;
the printed vectors agree within 2e-5 (two fp32 forwards summed in another
order, printed to 5 decimals; measured: the quaternion branch equal as
printed, the Matterport branch, whose translation is scaled by 5, one
step of the last decimal, 1e-5).
"""

import os

import numpy as np
import jax
import pytest
import torch
import cv2

from rel_pose_tpu.config import ModelConfig as JaxModelConfig
from rel_pose_tpu.models import vitess_init
from rel_pose_tpu.train.checkpoint import save_checkpoint
from rel_pose_tpu_torch.cli import demo as port_demo
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.infer import load_checkpoint_state_dict
from test_cli import REPO, make_matterport_tree, run_cli

HEADERS = {True: "predicted R&t, as quaternion, in format x,y,z,qx,qy,qz,qw:",
           False: "predicted R, as quaternion in format qx,qy,qz,qw"}
BRANCHES = {True: ("matterport_v.ckpt", "matterport/imgs/s0_0.png",
                   "matterport/imgs/s0_1.png"),
            False: ("interiornet_t.ckpt", "in_1.png", "in_2.png")}


def printed_vector(out, matterport):
    """The numbers printed after the branch's header line."""
    lines = out.splitlines()
    idx = lines.index(HEADERS[matterport])
    tail = " ".join(lines[idx + 1:]).replace("[", " ").replace("]", " ")
    return np.array([float(t) for t in tail.split()])


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The images, the two ``.ckpt`` names, a ``.pth`` of the same weights
    and the JAX demo's printed vectors."""
    wd = tmp_path_factory.mktemp("demo_cli")
    make_matterport_tree(str(wd / "matterport"), n=1)
    rng = np.random.default_rng(83)
    for name in ("in_1.png", "in_2.png"):
        cv2.imwrite(str(wd / name), rng.integers(0, 255, (128, 128, 3),
                                                 dtype=np.uint8))
    params, bn_state = vitess_init(
        jax.random.PRNGKey(5), JaxModelConfig(transformer_depth=2,
                                              fusion_transformer=True))
    want = {}
    for matterport, (ckpt, img1, img2) in BRANCHES.items():
        save_checkpoint(str(wd / ckpt),
                        {"params": params, "bn_state": bn_state})
        r = run_cli([os.path.join(REPO, "demo.py"), "--img1", img1,
                     "--img2", img2, "--ckpt", ckpt,
                     "--transformer_depth", "2"], cwd=str(wd))
        assert r.returncode == 0, r.stderr[-3000:]
        want[matterport] = printed_vector(r.stdout, matterport)
    sd = load_checkpoint_state_dict(str(wd / "matterport_v.ckpt"),
                                    ModelConfig(transformer_depth=2))
    for name in ("matterport_v.pth", "interiornet_t.pth"):
        torch.save({"model": sd}, wd / name)
    return wd, want


@pytest.mark.parametrize("matterport", [True, False])
@pytest.mark.parametrize("suffix", [".ckpt", ".pth"])
def test_demo_matches_jax(workdir, monkeypatch, capsys, matterport, suffix):
    wd, want = workdir
    ckpt, img1, img2 = BRANCHES[matterport]
    ckpt = ckpt.replace(".ckpt", suffix)
    monkeypatch.chdir(wd)
    assert port_demo.main(["--img1", img1, "--img2", img2, "--ckpt", ckpt,
                           "--transformer_depth", "2", "--device",
                           "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"predicting pose on {img1} and {img2} using "
                          f"model {ckpt}\n")
    got = printed_vector(out, matterport)
    assert got.shape == (7 if matterport else 4,)
    np.testing.assert_allclose(got, want[matterport], rtol=0, atol=2e-5)


def test_demo_branches_use_the_infer_conventions(workdir, monkeypatch):
    """``predict`` gives the predictor's pose after
    ``matterport_demo_pose`` for a ``matterport`` name, the raw pose (its
    quaternion printed) otherwise; ``--fusion_transformer`` is forced."""
    from rel_pose_tpu_torch.data.base import image_read
    from rel_pose_tpu_torch.infer import (MATTERPORT_INTRINSICS,
                                          PosePredictor, matterport_demo_pose)
    wd, _ = workdir
    monkeypatch.chdir(wd)
    ckpt, img1, img2 = BRANCHES[True]
    args = port_demo.build_parser().parse_args(
        ["--img1", img1, "--img2", img2, "--ckpt", ckpt,
         "--transformer_depth", "2"])
    assert not args.fusion_transformer
    is_mp, preds = port_demo.predict(args, torch.device("cpu"))
    assert is_mp and args.fusion_transformer
    pred = PosePredictor.from_checkpoint(
        ckpt, ModelConfig(transformer_depth=2), device="cpu",
        intrinsics=MATTERPORT_INTRINSICS, image_size=(384, 512))
    pose = pred.predict(image_read(img1), image_read(img2))[1]
    np.testing.assert_array_equal(preds, matterport_demo_pose(pose))


def test_demo_refuses_cuda_without_a_gpu(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        port_demo.main(["--img1", "a.png", "--img2", "b.png", "--ckpt",
                        "x.ckpt"])
    assert "no CUDA device" in str(e.value)
