"""The port's eval CLIs against the JAX package's, on the CPU.

``python test_matterport.py`` and ``python test_streetlearn_interiornet.py``
(the JAX package's, run once each per module in subprocesses side by
side, with tests/test_cli.py's environment) and the port's ``cli.test_matterport`` /
``cli.test_streetlearn_interiornet`` (``main([...,"--device", "cpu"])``
in-process) evaluate the same ``.ckpt`` -- the JAX package's seeded
flagship at depth 2, written by its ``save_checkpoint`` -- on the same
synthetic trees:

  * Matterport: tests/test_cli.py's ``make_matterport_tree`` at 120x160
    (5 pairs), its split rewritten with varied ground truths, two of them
    with W < 0 (the sign fix);
  * InteriorNet, its rotation set and its ``T`` set: 128x128 PNGs, 7 pairs
    whose viewpoints put the ground truth in both buckets and beyond 90
    degrees (dropped), keys stored out of order (the sort).

Tolerances, with their reasons: ``results.txt`` values within 1e-4 (metres
and fractions) and 1e-3 (degrees) -- both packages' fp32 forwards, summed
in another order, give poses within ~1e-6 (tests/test_torch_model.py), and
the metrics carry that through; the CSVs row by row within the same bounds
plus 1e-5, their ``%1.5f`` rounding.  The port's ``--batch`` 1 and 3
(a padded ragged tail) give the same results to 1e-4, metrics and CSVs:
a convolution blocks its sums by batch size on the CPU, and near 160
degrees, where these random weights put the errors, arccos multiplies a
rounding of the cosine by 1 / sin = 2.9 (an ulp of a float32 angle there
is 1.5e-5).  Measured gaps, port against JAX: Matterport results 4.1e-5,
CSVs 1.0e-4 (degrees) and 0 (metres); InteriorNet results 8.0e-5, CSVs
1.4e-4; the T set 6.0e-5 and 8.0e-5.  Port, batch 1 against 3:
Matterport 3.8e-5 / 4.0e-5, InteriorNet 2.0e-5 / 3.0e-5.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch
import cv2

from rel_pose_tpu.config import ModelConfig as JaxModelConfig
from rel_pose_tpu.models import vitess_init
from rel_pose_tpu.train.checkpoint import save_checkpoint
from rel_pose_tpu_torch.cli import test_matterport as port_mp
from rel_pose_tpu_torch.cli import test_streetlearn_interiornet as port_insl
from test_cli import REPO, make_matterport_tree

MODEL_FLAGS = ["--transformer_depth", "2", "--fusion_transformer"]
# (y1, y2) viewpoint yaws: ground-truth angles of about 11, 29, 57, 69
# and 103 degrees, and two more under 45
YAWS = [(0.1, -0.1), (0.3, -0.2), (0.2, -0.8), (0.0, -1.2), (0.9, -0.9),
        (-0.2, 0.05), (0.4, 0.0)]


def make_viewpoint_test_tree(root, meta, rng):
    """7 pairs of 128x128 PNGs under ``data/interiornet`` and their test
    metadata, keys inserted in reverse order."""
    split = {}
    for i in reversed(range(len(YAWS))):
        p1, p2 = f"s/{i}a.png", f"s/{i}b.png"
        for p in (p1, p2):
            full = os.path.join(root, "data", "interiornet", p)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            cv2.imwrite(full, rng.integers(0, 255, (128, 128, 3),
                                           dtype=np.uint8))
        split[i] = {"img1": {"path": p1, "x": 0.1, "y": YAWS[i][0]},
                    "img2": {"path": p2, "x": -0.05, "y": YAWS[i][1]}}
    os.makedirs(os.path.dirname(os.path.join(root, meta)), exist_ok=True)
    np.save(os.path.join(root, meta), np.array([split], dtype=object),
            allow_pickle=True)


def vary_matterport_ground_truth(root, rng):
    """Give each pair of the tree's test split its own pose; pairs 1 and
    3 get a quaternion with W < 0."""
    path = os.path.join(root, "mp3d_planercnn_json", "cached_set_test.json")
    split = json.load(open(path))
    for i, entry in enumerate(split["data"]):
        q = rng.standard_normal(4)
        q[0] = (abs(q[0]) + 1.0) * (-1 if i in (1, 3) else 1)
        entry["rel_pose"] = {"position": list(rng.standard_normal(3)),
                             "rotation": list(q / np.linalg.norm(q))}
    json.dump(split, open(path, "w"))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The trees, the ``.ckpt`` and the JAX CLIs' outputs (exp ``jax``)."""
    wd = tmp_path_factory.mktemp("eval_cli")
    rng = np.random.default_rng(71)
    make_matterport_tree(str(wd / "matterport"), n=5)
    vary_matterport_ground_truth(str(wd / "matterport"), rng)
    make_viewpoint_test_tree(str(wd / "inet"),
                             "metadata/interiornet/test_pair_rotation.npy",
                             rng)
    make_viewpoint_test_tree(str(wd / "inetT"),
                             "metadata/interiornetT/test_pair_translation.npy",
                             rng)
    params, bn_state = vitess_init(
        jax.random.PRNGKey(3), JaxModelConfig(transformer_depth=2,
                                              fusion_transformer=True))
    save_checkpoint(str(wd / "model.ckpt"),
                    {"params": params, "bn_state": bn_state})
    # the three JAX CLIs side by side: each spends most of its time
    # compiling its forward
    env = dict(os.environ, RELPOSE_PLATFORM="cpu", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, script), "--exp", "jax",
         "--ckpt", "model.ckpt", "--batch", "2"] + extra + MODEL_FLAGS,
        cwd=str(wd), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for script, extra in (
            ("test_matterport.py", ["--datapath", "matterport"]),
            ("test_streetlearn_interiornet.py", ["--datapath", "inet"]),
            ("test_streetlearn_interiornet.py",
             ["--datapath", "inetT", "--streetlearn_interiornet_type", "T"]))]
    for p in procs:
        _, err = p.communicate(timeout=1200)
        assert p.returncode == 0, err[-3000:]
    return wd


def read_results(path):
    out = {}
    for line in open(path).read().strip().splitlines():
        k, v = line.rsplit(" ", 1)
        out[k] = float(v)
    return out


def read_csv(path):
    return np.loadtxt(path, delimiter=",", ndmin=1)


def gap(a, b, keys):
    """The largest |a - b| over ``keys`` of two results dicts."""
    return max(abs(a[k] - b[k]) for k in keys)


MP_FILES = ["gt_translation_magnitude_vs_error.csv",
            "gt_rotation_magnitude_vs_error.csv"]
INSL_FILES = ["all_rotation_err_degrees.csv", "all_gt_rot_degrees.csv"]


def run_port(module, exp, workdir, monkeypatch, batch, *extra):
    monkeypatch.chdir(workdir)
    assert module.main(["--exp", exp, "--ckpt", "model.ckpt", "--batch",
                        str(batch), "--device", "cpu"] + list(extra)
                       + MODEL_FLAGS) == 0


def assert_results_match(jax_dir, port_dir, degree_keys, files, degree_cols):
    """results.txt within 1e-4 / 1e-3 degrees; the CSVs row by row, the
    columns in ``degree_cols`` (per file) within 1e-3 + 1e-5."""
    want = read_results(os.path.join(jax_dir, "results.txt"))
    got = read_results(os.path.join(port_dir, "results.txt"))
    assert got.keys() == want.keys()
    for k in want:
        tol = 1e-3 if k in degree_keys else 1e-4
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    for name, cols in zip(files, degree_cols):
        a = read_csv(os.path.join(port_dir, name))
        b = read_csv(os.path.join(jax_dir, name))
        assert a.shape == b.shape, name
        diff = np.abs(a - b).reshape(len(a), -1)
        tol = np.where(np.isin(np.arange(diff.shape[1]), cols), 1e-3,
                       1e-4) + 1e-5
        assert (diff <= tol).all(), (name, diff.max(axis=0))
    return want, got


def test_matterport_matches_jax_cli(workdir, monkeypatch, capsys):
    """The Matterport CLI's results.txt and CSVs match the JAX CLI's on the
    same ``.ckpt`` and tree; the ground truths with W < 0 were flipped
    (their rotation-magnitude column is under 180 degrees either way, so
    the check is the error column's agreement)."""
    run_port(port_mp, "port", workdir, monkeypatch, 3,
             "--datapath", "matterport")
    out = capsys.readouterr().out
    assert "performing evaluation on matterport_test set" in out
    assert "throughput:" in out
    base = workdir / "output"
    want, got = assert_results_match(
        base / "jax" / "matterport_test", base / "port" / "matterport_test",
        {"R mean err", "R median err"}, MP_FILES, [[], [0, 1]])
    assert len(read_csv(base / "port" / "matterport_test" / MP_FILES[0])) == 5


def test_matterport_batch_sizes_agree(workdir, monkeypatch):
    """``--batch`` 1 and 3 (5 pairs: a padded tail of 2) give the same
    metrics and CSVs."""
    for b in (1, 3):
        run_port(port_mp, f"b{b}", workdir, monkeypatch, b,
                 "--datapath", "matterport")
    d1 = workdir / "output" / "b1" / "matterport_test"
    d3 = workdir / "output" / "b3" / "matterport_test"
    r1, r3 = read_results(d1 / "results.txt"), read_results(d3 / "results.txt")
    assert r1.keys() == r3.keys()
    assert gap(r1, r3, r1) <= 1e-4
    for name in MP_FILES:
        np.testing.assert_allclose(read_csv(d1 / name), read_csv(d3 / name),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("datapath,folder,extra", [
    ("inet", "interiornet_test", []),
    ("inetT", "interiornetT_test", ["--streetlearn_interiornet_type", "T"]),
])
def test_interiornet_matches_jax_cli(workdir, monkeypatch, datapath, folder,
                                     extra):
    """The InteriorNet CLI (rotation set and ``T`` set) against the JAX
    CLI: both buckets' mean / median (degrees) and 10-degree share, and
    the CSVs of the pairs under 90 degrees (6 of 7)."""
    run_port(port_insl, "port", workdir, monkeypatch, 3,
             "--datapath", datapath, "--dataset", "interiornet", *extra)
    base = workdir / "output"
    want, _ = assert_results_match(
        base / "jax" / folder, base / "port" / folder,
        {k for k in read_results(base / "jax" / folder / "results.txt")
         if not k.endswith("10deg")}, INSL_FILES, [[0], [0]])
    assert {k.split("/")[0] for k in want} == {
        "rotation_geodesic_error_overlap_large",
        "rotation_geodesic_error_overlap_small"}
    assert len(read_csv(base / "port" / folder / INSL_FILES[0])) == 6


def test_interiornet_batch_sizes_agree(workdir, monkeypatch):
    for b in (1, 3):
        run_port(port_insl, f"b{b}", workdir, monkeypatch, b,
                 "--datapath", "inet")
    d1 = workdir / "output" / "b1" / "interiornet_test"
    d3 = workdir / "output" / "b3" / "interiornet_test"
    r1, r3 = read_results(d1 / "results.txt"), read_results(d3 / "results.txt")
    assert gap(r1, r3, r1) <= 1e-4
    for name in INSL_FILES:
        np.testing.assert_allclose(read_csv(d1 / name), read_csv(d3 / name),
                                   rtol=0, atol=1e-4)


def test_pth_and_ckpt_give_the_same_files(workdir, monkeypatch):
    """The same weights as a port ``.pth``: byte-identical results.txt and
    CSVs."""
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.infer import load_checkpoint_state_dict
    sd = load_checkpoint_state_dict(str(workdir / "model.ckpt"),
                                    ModelConfig(transformer_depth=2))
    torch.save({"model": sd}, workdir / "model.pth")
    monkeypatch.chdir(workdir)
    for ckpt, exp in (("model.ckpt", "from_ckpt"), ("model.pth", "from_pth")):
        assert port_mp.main(["--exp", exp, "--ckpt", ckpt, "--batch", "2",
                             "--device", "cpu", "--datapath", "matterport"]
                            + MODEL_FLAGS) == 0
    a = workdir / "output" / "from_ckpt" / "matterport_test"
    b = workdir / "output" / "from_pth" / "matterport_test"
    for name in ["results.txt"] + MP_FILES:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("dataset,kind,want", [
    ("interiornet", "", ("metadata/interiornet/test_pair_rotation.npy",
                         "interiornet_test", "interiornet")),
    ("interiornet", "nooverlap",
     ("metadata/interiornet/test_pair_rotation.npy", "interiornet_test",
      "interiornet")),
    ("interiornet", "T", ("metadata/interiornetT/test_pair_translation.npy",
                          "interiornetT_test", "interiornet")),
    ("streetlearn", "nooverlapT",
     ("metadata/streetlearn/test_pair_rotation.npy", "streetlearn_test",
      "streetlearn")),
    ("streetlearn", "T", ("metadata/streetlearnT/test_pair_translation.npy",
                          "streetlearnT_test", "streetlearn_2016")),
])
def test_metadata_dispatch(dataset, kind, want):
    """``T`` picks the translation set, every other type aliases to the
    rotation set, and StreetLearn's T images are under streetlearn_2016
    (``test_streetlearn_interiornet.py:107-125``)."""
    assert port_insl.select_metadata(dataset, kind) == want


def test_matterport_image_path_and_sign_fix():
    """The split's paths lose their first 6 components; a W-first ground
    truth with W < 0 is negated, one with W >= 0 kept."""
    assert port_mp.image_path("root", "a/b/c/d/e/f/imgs/x.png") == \
        os.path.join("root", "imgs/x.png")
    entry = {"rel_pose": {"position": [1, 2, 3],
                          "rotation": [-0.5, 0.5, -0.5, 0.5]}}
    assert port_mp.ground_truth(entry) == ([1, 2, 3], [0.5, -0.5, 0.5, -0.5])
    entry["rel_pose"]["rotation"] = [0.0, 1.0, 0.0, 0.0]
    assert port_mp.ground_truth(entry)[1] == [0.0, 1.0, 0.0, 0.0]


@pytest.mark.parametrize("module", [port_mp, port_insl])
def test_refuses_cuda_without_a_gpu(tmp_path, monkeypatch, module):
    """``--device cuda`` (the default) on a host without a GPU refuses
    with a message before anything is written."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        module.main(["--exp", "x", "--ckpt", "model.ckpt", "--datapath",
                     "matterport"])
    assert "no CUDA device" in str(e.value)
    assert not os.path.exists("output")
