"""PyTorch port vs the JAX package: the data pipeline and the native
host library.

The port's ``data/`` and ``native/`` are copies of the JAX package's, so
they are held to it exactly on synthetic trees (Matterport from
tests/test_cli.py's ``make_matterport_tree``; InteriorNet / StreetLearn and
their -T variants by :func:`make_viewpoint_tree`, the tree of
tests/test_cli.py's ``test_train_interiornet``):

  * ``scene_info``: Matterport bit for bit; the InteriorNet / StreetLearn
    quaternions within 1e-6 (float32 rotations: the JAX package computes
    them with XLA's cos / sin and 3x3 product, the port with numpy's; 2e-8
    measured), image paths and intrinsics exact;
  * ``__getitem__`` with ``augment=True`` under the same
    ``np.random.default_rng(s)``: the same bytes, on the native path (the
    JAX package handed the port's compiled library, so that the test
    builds no other) and on the numpy path, with the decode levers
    (``RELPOSE_DECODE_REDUCE``, ``RELPOSE_DECODE_CACHE_MB``) and the
    jitter order (``RELPOSE_JITTER_FULLRES``) set and unset;
  * ``DataLoader``: the same batches in the same order for the same seed,
    epoch and shards;
  * the port's native library against its numpy path, as
    tests/test_native.py holds the JAX copy: resizes bitwise, each jitter
    op within 0.05 of 255 and the full chain within 0.1 (float
    association), the fused jitter bitwise equal to the one-pass-per-op
    path, the resize-quantize epilogue bitwise, and the whole augmentor's
    uint8 output off by more than 1 in under 0.1% of pixels, never by more
    than 2;
  * concurrent builds of the library: each writes its own temporary file
    and renames it into place.
"""

import os
import threading

import numpy as np
import pytest

from rel_pose_tpu import data as jdata
from rel_pose_tpu import native as jnative
from rel_pose_tpu.data import base as jbase
from rel_pose_tpu_torch import data as tdata
from rel_pose_tpu_torch import native as tnative
from rel_pose_tpu_torch.data import augmentation as taug
from rel_pose_tpu_torch.data import base as tbase
from test_cli import make_matterport_tree

import cv2

RNG = np.random.default_rng(0)
VIEWPOINT_DIRS = {  # (dataset, type) -> (metadata file, image directory)
    ("interiornet", ""): ("metadata/interiornet/"
                          "train_pair_rotation_overlap.npy", "interiornet"),
    ("interiornet", "T"): ("metadata/interiornetT/"
                           "train_pair_translation_overlap.npy",
                           "interiornet"),
    ("streetlearn", ""): ("metadata/streetlearn/"
                          "train_pair_rotation_overlap.npy", "streetlearn"),
    ("streetlearn", "T"): ("metadata/streetlearnT/"
                           "train_pair_translation_overlap.npy",
                           "streetlearn_2016"),
}


def make_viewpoint_tree(root, dataset="interiornet", type_="", n=20,
                        hw=(128, 128), seed=2):
    """An InteriorNet / StreetLearn(-T) training tree: ``n`` pairs of PNGs
    with viewpoints (0.2, 0.1 i) and (0.1, -0.2), as
    tests/test_cli.py's ``test_train_interiornet`` writes."""
    meta, img_dir = VIEWPOINT_DIRS[dataset, type_]
    rng = np.random.default_rng(seed)
    split = {}
    for i in range(n):
        p1, p2 = f"s/{i}a.png", f"s/{i}b.png"
        for p in (p1, p2):
            full = os.path.join(root, "data", img_dir, p)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            cv2.imwrite(full, rng.integers(0, 255, (*hw, 3), dtype=np.uint8))
        split[i] = {"img1": {"path": p1, "x": 0.2, "y": 0.1 * i},
                    "img2": {"path": p2, "x": 0.1, "y": -0.2}}
    os.makedirs(os.path.dirname(os.path.join(root, meta)), exist_ok=True)
    np.save(os.path.join(root, meta), np.array([split], dtype=object),
            allow_pickle=True)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    out = {"matterport": str(base / "mp")}
    make_matterport_tree(out["matterport"], n=4, hw=(120, 160))
    for (ds, t) in VIEWPOINT_DIRS:
        out[ds, t] = make_viewpoint_tree(str(base / f"{ds}{t}"), ds, t)
    return out


def _datasets(name, root, **kwargs):
    cls = {"matterport": "Matterport", "interiornet": "InteriorNet",
           "streetlearn": "StreetLearn"}[name]
    return (getattr(jdata, cls)(datapath=root, **kwargs),
            getattr(tdata, cls)(datapath=root, **kwargs))


@pytest.mark.parametrize("subepoch", [0, 10])
def test_matterport_scene_info_is_jax_s(trees, subepoch):
    j, t = _datasets("matterport", trees["matterport"], subepoch=subepoch)
    assert len(t) == len(j) == 4
    assert t.scene_info["images"] == j.scene_info["images"]
    for key in ("poses", "intrinsics"):
        for a, b in zip(t.scene_info[key], j.scene_info[key]):
            assert a.dtype == b.dtype and np.array_equal(a, b), key


@pytest.mark.parametrize("dataset,type_,subepoch,mini", [
    ("interiornet", "", 0, False), ("interiornet", "", 7, False),
    ("interiornet", "T", 3, False), ("streetlearn", "", 0, False),
    ("streetlearn", "T", 9, False), ("interiornet", "", 0, True),
])
def test_viewpoint_scene_info_matches_jax(trees, dataset, type_, subepoch,
                                          mini):
    j, t = _datasets(dataset, trees[dataset, type_], subepoch=subepoch,
                     streetlearn_interiornet_type=type_,
                     use_mini_dataset=mini)
    assert len(t) == len(j) == (20 if mini else 2)
    assert t.scene_info["images"] == j.scene_info["images"]
    for a, b in zip(t.scene_info["intrinsics"], j.scene_info["intrinsics"]):
        assert np.array_equal(a, b)
    for a, b in zip(t.scene_info["poses"], j.scene_info["poses"]):
        assert a.shape == b.shape == (2, 7)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.fixture(params=["native", "numpy"])
def host_path(request, monkeypatch):
    """Both packages on the port's native library, or both on numpy."""
    if request.param == "native":
        assert tnative.available(), tnative.build_error()
        monkeypatch.setattr(jnative, "_lib", tnative._load())
    else:
        monkeypatch.setattr(jnative, "_lib", False)
        monkeypatch.setattr(tnative, "_lib", False)
    return request.param


@pytest.mark.parametrize("env", [
    {}, {"RELPOSE_JITTER_FULLRES": "1"},
    {"RELPOSE_DECODE_REDUCE": "2", "RELPOSE_DECODE_CACHE_MB": "64"},
])
@pytest.mark.parametrize("name", ["matterport", "streetlearn"])
def test_getitem_bitwise_equal_to_jax(trees, host_path, monkeypatch, env,
                                      name):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    root = trees[name] if name == "matterport" else trees[name, "T"]
    kw = dict(subepoch=1, streetlearn_interiornet_type="" if
              name == "matterport" else "T")
    for s in range(3):
        j = _datasets(name, root, augment=True,
                      rng=np.random.default_rng(s), **kw)[0]
        t = _datasets(name, root, augment=True,
                      rng=np.random.default_rng(s), **kw)[1]
        for index in range(len(t)):
            got, want = t[index], j[index]
            assert got[0].dtype == np.uint8
            assert got[0].shape == (2, 3, 384, 512)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_decode_cache_hits(trees, monkeypatch):
    """``RELPOSE_DECODE_CACHE_MB`` keeps decoded images: a second pass
    over the dataset decodes nothing."""
    monkeypatch.setenv("RELPOSE_DECODE_CACHE_MB", "32")
    monkeypatch.setattr(tbase, "_decode_cache", None)
    t = _datasets("matterport", trees["matterport"], subepoch=0,
                  augment=False)[1]
    for _ in range(2):
        for i in range(len(t)):
            t[i]
    cache = tbase.decode_cache()
    assert (cache.misses, cache.hits) == (8, 8)


class _Indexed:
    """A dataset whose sample i is (i, -i) as arrays."""

    def __len__(self):
        return 23

    def __getitem__(self, i):
        return np.array([i]), np.array([-i, i])


@pytest.mark.parametrize("kw", [
    dict(seed=0, epoch=0), dict(seed=3, epoch=14, num_workers=3),
    dict(seed=0, epoch=2, num_shards=4, shard_index=1),
    dict(seed=5, epoch=1, shuffle=False, drop_last=False),
    dict(seed=1, epoch=0, num_shards=3, shard_index=2, drop_last=False,
         num_workers=2),
])
def test_loader_batches_match_jax(kw):
    kw = dict(dict(num_workers=1), **kw)
    got = list(tdata.DataLoader(_Indexed(), batch_size=4, **kw))
    want = list(jdata.DataLoader(_Indexed(), batch_size=4, **kw))
    assert len(got) == len(want) == len(tdata.DataLoader(
        _Indexed(), batch_size=4, **kw)) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)


def test_loader_over_a_tree_matches_jax(trees, host_path):
    j, t = _datasets("matterport", trees["matterport"], subepoch=0,
                     augment=False)
    got = list(tdata.DataLoader(t, batch_size=2, seed=0, epoch=3,
                                num_workers=2))
    want = list(jdata.DataLoader(j, batch_size=2, seed=0, epoch=3,
                                 num_workers=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)


# ------------------------------------- the port's native vs its numpy path --

@pytest.fixture
def native():
    assert tnative.available(), tnative.build_error()
    return tnative


def _numpy_chain(chw, draws):
    rgb = chw[:, ::-1] / 255.0
    fns = {0: taug._adjust_brightness, 1: taug._adjust_contrast,
           2: taug._adjust_saturation, 3: taug._adjust_hue}
    for code, f in draws:
        if code == 4:
            rgb = np.broadcast_to(taug._rgb_to_gray(rgb), rgb.shape).copy()
        else:
            rgb = np.clip(fns[code](rgb, f), 0.0, 1.0)
    return (rgb[:, ::-1] * 255.0).astype(np.float32)


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 60, 80, 3), (60, 80)), ((2, 480, 640, 3), (384, 512)),
    ((1, 100, 100, 3), (256, 256)),
])
def test_native_resize_matches_numpy(native, shape, out_hw):
    imgs = RNG.integers(0, 255, shape, dtype=np.uint8)
    out = native.pair_to_chw_resize(imgs, out_hw)
    rows = (np.arange(out_hw[0]) * shape[1]) // out_hw[0]
    cols = (np.arange(out_hw[1]) * shape[2]) // out_hw[1]
    ref = imgs[:, rows][:, :, cols].transpose(0, 3, 1, 2).astype(np.float32)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("draws", [[(0, 1.2)], [(1, 0.8)], [(2, 1.15)],
                                   [(3, 0.07)], [(3, -0.1)], [(4, 0.0)]])
def test_native_jitter_op_matches_numpy(native, draws):
    chw = RNG.uniform(0, 255, (2, 3, 64, 64)).astype(np.float32)
    nat = native.color_jitter(chw.copy(), [d[0] for d in draws],
                              [d[1] for d in draws])
    np.testing.assert_allclose(nat, _numpy_chain(chw, draws), atol=0.05)


def test_native_jitter_chain_matches_numpy(native):
    chw = RNG.uniform(0, 255, (2, 3, 120, 160)).astype(np.float32)
    draws = [(2, 1.1), (0, 0.85), (3, 0.05), (1, 1.2), (4, 0.0)]
    nat = native.color_jitter(chw.copy(), [d[0] for d in draws],
                              [d[1] for d in draws])
    np.testing.assert_allclose(nat, _numpy_chain(chw, draws), atol=0.1)


@pytest.mark.parametrize("draws", [
    [(3, 0.06), (0, 1.2), (1, 0.85), (2, 1.1), (4, 0.0)], [(1, 0.9)],
    [(1, 1.1), (3, -0.1)], [(0, 0.8), (2, 1.2), (3, -0.1), (1, 1.15)],
    [(0, 1.05), (2, 0.95)], [(4, 0.0)],
])
def test_native_fused_jitter_bitwise_equals_multipass(native, draws):
    chw = RNG.uniform(0, 255, (2, 3, 120, 160)).astype(np.float32)
    ops, vals = [d[0] for d in draws], [d[1] for d in draws]
    multi = native.color_jitter(chw.copy(), ops, vals, fused=False)
    fused = native.color_jitter(chw.copy(), ops, vals, fused=True)
    np.testing.assert_array_equal(fused, multi)


def test_native_resize_quantize_matches_numpy(native):
    x = RNG.uniform(-5, 260, (2, 3, 37, 53)).astype(np.float32)
    x[0, 0, :4, :4] = np.float32([[0.5, 1.5, 2.5, 3.5]] * 4)
    got = native.resize_quantize(x, (21, 32))
    rows = (np.arange(21) * 37) // 21
    cols = (np.arange(32) * 53) // 32
    ref = np.clip(np.rint(x[..., rows, :][..., cols]), 0, 255)
    np.testing.assert_array_equal(got, ref.astype(np.uint8))


def test_native_augmentor_matches_numpy_path(native, monkeypatch):
    images = RNG.uniform(0, 255, (2, 3, 96, 128)).astype(np.float32)
    intr = np.float32([[90, 95, 60, 45]] * 2)
    o1, _, i1 = taug.RGBDAugmentor((64, 96), rng=np.random.default_rng(9))(
        images.copy(), None, intr.copy())
    monkeypatch.setattr(tnative, "_lib", False)
    o2, _, i2 = taug.RGBDAugmentor((64, 96), rng=np.random.default_rng(9))(
        images.copy(), None, intr.copy())
    np.testing.assert_allclose(i1, i2, rtol=1e-6)
    diff = o1.astype(np.int16) - o2.astype(np.int16)
    assert np.mean(np.abs(diff) > 1) < 1e-3 and np.abs(diff).max() <= 2


def test_concurrent_builds_never_expose_a_partial_library(tmp_path,
                                                          monkeypatch):
    """Four builds at once into one directory: each compiles to a name of
    its own and renames it into place, so the library that is there
    afterwards loads and no temporary file is left."""
    lib = str(tmp_path / "librelpose_host.so")
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_LIB_PATH", lib)
    ok = []
    threads = [threading.Thread(target=lambda: ok.append(tnative._build()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert ok == [True] * 4, tnative._build_error
    assert os.listdir(tmp_path) == ["librelpose_host.so"]
    monkeypatch.setattr(tnative, "_lib", None)
    assert tnative.available()
    out = tnative.pair_to_chw_resize(np.zeros((1, 4, 4, 3), np.uint8), (2, 2))
    assert out.shape == (1, 3, 2, 2)
