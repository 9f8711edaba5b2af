"""Dataset base classes (host-side, pure numpy).

A copy of ``rel_pose_tpu/data/base.py`` for the port: the same files and
the same seeded ``rng`` give the same bytes.

Functional equivalent of the reference's ``RGBDDataset``
(``src/data_readers/base.py``): each sample is
``(images (2, 3, H, W) uint8 BGR 0-255, poses (2, 7), intrinsics (2, 4))``
with pose 0 = identity and pose 1 = the relative pose (W-last quaternion).
Images are uint8 (the reference's ColorJitter output domain is PIL uint8
too); the model casts in-graph — 4x less host->device traffic.

Image decode uses cv2 when available (BGR, identical to the reference) and
falls back to PIL with an RGB->BGR flip.

Host-throughput levers (decode was the largest host stage of the JAX
package's pipeline, ``docs/PROFILE.md``; the port's share is measured by
``chip_smoke.py``'s CLI phase):

- ``RELPOSE_DECODE_REDUCE={2,4,8}`` — decode JPEGs at 1/k scale via
  libjpeg's DCT-domain scaling (``cv2.IMREAD_REDUCED_COLOR_k``), ~3x
  cheaper at k=2.  The model downscales to 224x224 anyway, so a 1/2-scale
  480x640 source (240x320) still oversamples the network input, but the
  resampling chain differs from the reference's — OPT-IN; eval-metric
  parity is CI-gated on synthetic band-limited images AND on the
  reference's 6 real demo photos (``tests/test_cli.py``, observed real-
  photo deltas: R mean err 0.07 deg of ~98, T 0.007 of ~5.8 — decode
  resampling noise), pending a full real-dataset validation.  Intrinsics
  stay correct automatically (the augmentor rescales from the decoded
  resolution).
- ``RELPOSE_DECODE_CACHE_MB=<n>`` — bounded process-wide LRU of decoded
  images.  Matterport pairs reuse images across pairs within a scene and
  the train loop re-reads every image each epoch; cache hits skip the
  decode entirely.  Thread-safe (the loader's decode workers are threads).
"""

import os
import threading
from collections import OrderedDict

import numpy as np

try:
    import cv2
    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    _HAVE_CV2 = False
    from PIL import Image

_REDUCE_FLAGS = {}
if _HAVE_CV2:
    _REDUCE_FLAGS = {1: cv2.IMREAD_COLOR,
                     2: cv2.IMREAD_REDUCED_COLOR_2,
                     4: cv2.IMREAD_REDUCED_COLOR_4,
                     8: cv2.IMREAD_REDUCED_COLOR_8}


def image_read(path, reduce=1):
    """Decode an image file to (H, W, 3) uint8 BGR (cv2.imread semantics).

    ``reduce`` in {1, 2, 4, 8}: decode at 1/reduce scale (JPEG: DCT-domain,
    ~reduce^2 cheaper; PNG: full decode + internal scale, little gain)."""
    if _HAVE_CV2:
        img = cv2.imread(path, _REDUCE_FLAGS[reduce])
        if img is None:
            raise IOError(f"failed to read image: {path}")
        return img
    img = Image.open(path)
    if reduce > 1:
        img.draft("RGB", (img.width // reduce, img.height // reduce))
    img = np.asarray(img.convert("RGB"))
    return img[:, :, ::-1].copy()


class _DecodeCache:
    """Bounded thread-safe LRU of decoded images, keyed (path, reduce)."""

    def __init__(self, budget_bytes):
        self.budget = budget_bytes
        self.used = 0
        self.lock = threading.Lock()
        self.data = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, path, reduce):
        key = (path, reduce)
        with self.lock:
            img = self.data.get(key)
            if img is not None:
                self.data.move_to_end(key)
                self.hits += 1
                return img
            self.misses += 1
        img = image_read(path, reduce)
        with self.lock:
            if key not in self.data:
                self.data[key] = img
                self.used += img.nbytes
                while self.used > self.budget and len(self.data) > 1:
                    _, old = self.data.popitem(last=False)
                    self.used -= old.nbytes
        return img


_decode_cache = None
_decode_cache_lock = threading.Lock()


def decode_cache():
    """The process-wide decode cache, or None (RELPOSE_DECODE_CACHE_MB)."""
    global _decode_cache
    mb = int(os.environ.get("RELPOSE_DECODE_CACHE_MB", "0"))
    if mb <= 0:
        return None
    with _decode_cache_lock:
        if _decode_cache is None or _decode_cache.budget != mb * (1 << 20):
            _decode_cache = _DecodeCache(mb * (1 << 20))
    return _decode_cache


def image_read_cached(path, reduce=1):
    cache = decode_cache()
    if cache is None:
        return image_read(path, reduce)
    return cache.get(path, reduce)


class RGBDDataset:
    """Base reader.  Subclasses implement ``_build_dataset`` returning
    ``{'images': [...], 'poses': [...], 'intrinsics': [...]}``."""

    #: whether __getitem__ should skip unreadable samples by advancing the
    #: index (reference behavior for InteriorNet/StreetLearn,
    #: ``base.py:70-97``)
    skip_bad_samples = False

    def __init__(self, name, datapath, reshape_size=(384, 512), subepoch=None,
                 is_training=True, streetlearn_interiornet_type="",
                 use_mini_dataset=False, augment=True, rng=None):
        from .augmentation import RGBDAugmentor

        self.root = datapath
        self.name = name
        self.streetlearn_interiornet_type = streetlearn_interiornet_type
        self.use_mini_dataset = use_mini_dataset
        self.is_training = is_training
        # NOTE: the reference applies the photometric augmentor to ALL splits
        # including validation (base.py:66,92 call it unconditionally); we
        # keep that semantic by default but let callers disable the
        # photometric part (the resize always runs — it is geometry, not
        # augmentation).
        if augment:
            self.aug = RGBDAugmentor(reshape_size, rng=rng)
        else:
            self.aug = RGBDAugmentor(reshape_size, rng=rng, brightness=0,
                                     contrast=0, saturation=0, hue=0,
                                     p_gray=0)
        self.reshape_size = reshape_size
        self.scene_info = self._build_dataset(subepoch)

    def _build_dataset(self, subepoch):
        raise NotImplementedError

    def _load(self, index):
        images_list = self.scene_info["images"][index]
        poses = np.stack(self.scene_info["poses"][index]).astype(np.float32)
        intrinsics = np.stack(
            self.scene_info["intrinsics"][index]).astype(np.float32)
        reduce = int(os.environ.get("RELPOSE_DECODE_REDUCE", "1"))
        images = np.stack([image_read_cached(p, reduce)
                           for p in images_list])
        in_h, in_w = images.shape[1:3]
        sizey, sizex = self.reshape_size
        # Resize BEFORE the photometric jitter (reference order is jitter
        # first, ``augmentation.py:19-38``): the nearest resize is a pure
        # pixel subset, so the pixelwise jitter ops commute with it exactly
        # — only contrast's scalar mean is re-estimated over the subset
        # (augmentation is stochastic; the distribution is unchanged).
        # Every downstream stage then touches 0.64x the pixels at the
        # production 480x640 -> 384x512 geometry.
        # RELPOSE_JITTER_FULLRES=1 restores the reference order.
        pre_resize = not os.environ.get("RELPOSE_JITTER_FULLRES")
        out_hw = (sizey, sizex) if pre_resize else (in_h, in_w)
        from .. import native
        if native.available():
            # fused uint8 HWC -> float32 CHW (+ nearest resize) in C++
            # (GIL-free, threaded; same floor(dst*in/out) mapping as the
            # augmentor's numpy gather)
            chw = native.pair_to_chw_resize(images, out_hw)
        else:
            chw = None
        if chw is None:
            chw = images.astype(np.float32).transpose(0, 3, 1, 2)
            if out_hw != (in_h, in_w):
                rows = (np.arange(out_hw[0]) * in_h) // out_hw[0]
                cols = (np.arange(out_hw[1]) * in_w) // out_hw[1]
                chw = np.ascontiguousarray(chw[..., rows, :][..., cols])
        if chw.shape[-2:] != (in_h, in_w):
            # pre-resized: the augmentor sees matching shapes and scales
            # intrinsics by 1 — apply the real rescale here
            intrinsics = intrinsics.copy()
            intrinsics[:, [0, 2]] *= sizex / in_w
            intrinsics[:, [1, 3]] *= sizey / in_h
        images, poses, intrinsics = self.aug(chw, poses, intrinsics)
        return images, poses, intrinsics

    def __getitem__(self, index):
        if not self.skip_bad_samples:
            return self._load(index)
        local = index
        # skip unreadable/corrupt samples by advancing (base.py:70-97)
        for _ in range(len(self)):
            try:
                return self._load(local % len(self))
            except Exception:
                local += 1
        raise RuntimeError("no readable samples in dataset")

    def __len__(self):
        return len(self.scene_info["images"])


class ConcatDataset:
    """Minimal concatenation of datasets (replaces
    torch.utils.data.ConcatDataset used at ``factory.py:10,23``)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, index):
        if index < 0:
            index += len(self)
        ds = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[ds][index - int(self._offsets[ds])]
