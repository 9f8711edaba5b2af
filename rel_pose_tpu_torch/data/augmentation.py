"""Host-side photometric augmentation (pure numpy, no PIL/torchvision).

A copy of ``rel_pose_tpu/data/augmentation.py``: the same ``rng`` draws
give the same bytes.

Numpy re-implementation of the reference's ``RGBDAugmentor``
(``src/data_readers/augmentation.py``):
ColorJitter(brightness=0.25, contrast=0.25, saturation=0.25, hue=0.4/3.14) +
RandomGrayscale(p=0.1), applied to the two images of a pair JOINTLY (the
reference concatenates them side-by-side first, ``augmentation.py:22``), then
a nearest resize to ``reshape_size`` with matching intrinsics rescale.

torchvision ColorJitter semantics replicated: each enabled transform draws a
factor uniformly from [max(0, 1-j), 1+j] (hue from [-h, h]) and the four
transforms are applied in a random order.  Grayscale uses ITU-R 601 luma
weights like PIL's 'L' mode.  Exact PIL uint8 rounding is not reproduced (the
reference feeds float tensors through ToPILImage/ToTensor, which quantizes to
uint8; augmentation is stochastic so bitwise parity is meaningless — the
distribution matches).
"""

import numpy as np


def _rgb_to_gray(rgb):
    """(..., 3, H, W) RGB -> (..., 1, H, W) luma."""
    w = np.array([0.299, 0.587, 0.114], dtype=rgb.dtype)
    return np.einsum("...chw,c->...hw", rgb, w)[..., None, :, :]


def _blend(a, b, factor):
    return factor * a + (1.0 - factor) * b


def _adjust_brightness(rgb, factor):
    return rgb * factor


def _adjust_contrast(rgb, factor):
    # joint mean over the whole stack: the reference concatenates the pair
    # side-by-side before jittering (augmentation.py:22), so torchvision's
    # contrast blends against the mean of BOTH images.
    mean = _rgb_to_gray(rgb).mean()
    return _blend(rgb, mean, factor)


def _adjust_saturation(rgb, factor):
    return _blend(rgb, _rgb_to_gray(rgb), factor)


def _adjust_hue(rgb, shift):
    """Hue rotation by ``shift`` (fraction of a full turn) via HSV."""
    r, g, b = rgb[..., 0, :, :], rgb[..., 1, :, :], rgb[..., 2, :, :]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    diff = maxc - minc
    s = np.where(maxc > 0, diff / np.maximum(maxc, 1e-12), 0.0)
    safe = np.where(diff > 0, diff, 1.0)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(diff > 0, h, 0.0)

    h = (h + shift) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r2, g2, b2], axis=-3)


class RGBDAugmentor:
    """Photometric jitter + resize for a stacked image pair.

    __call__(images (2, 3, H, W) BGR float 0-255, poses, intrinsics (2, 4))
      -> same shapes, resized to ``reshape_size``.
    """

    def __init__(self, reshape_size, rng=None, brightness=0.25, contrast=0.25,
                 saturation=0.25, hue=0.4 / 3.14, p_gray=0.1):
        self.reshape_size = reshape_size
        self.rng = rng or np.random.default_rng()
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.p_gray = p_gray

    def _draw_ops(self):
        """Sample the jitter chain: (op_code, factor) pairs in random order
        + optional trailing grayscale.  Op codes match ``native`` OP_*."""
        draws = []
        if self.brightness > 0:
            draws.append((0, self.rng.uniform(max(0.0, 1 - self.brightness),
                                              1 + self.brightness)))
        if self.contrast > 0:
            draws.append((1, self.rng.uniform(max(0.0, 1 - self.contrast),
                                              1 + self.contrast)))
        if self.saturation > 0:
            draws.append((2, self.rng.uniform(max(0.0, 1 - self.saturation),
                                              1 + self.saturation)))
        if self.hue > 0:
            draws.append((3, self.rng.uniform(-self.hue, self.hue)))
        draws = [draws[i] for i in self.rng.permutation(len(draws))]
        if self.rng.uniform() < self.p_gray:
            draws.append((4, 0.0))
        return draws

    def color_transform(self, images):
        """images: (2, 3, H, W) BGR 0-255 -> jittered, same layout.
        Both images receive the SAME jitter draw (reference concatenates the
        pair before jittering, ``augmentation.py:19-24``).

        Uses the multithreaded C++ pipeline (``rel_pose_tpu_torch.native``)
        when available; numpy otherwise (same math, verified in tests).
        """
        draws = self._draw_ops()
        if not draws:
            return images.astype(np.float32)

        from .. import native
        if native.available():
            buf = np.ascontiguousarray(images, dtype=np.float32)
            out = native.color_jitter(buf, [d[0] for d in draws],
                                      [d[1] for d in draws])
            if out is not None:
                return out

        rgb = images[:, ::-1] / 255.0
        fns = {0: _adjust_brightness, 1: _adjust_contrast,
               2: _adjust_saturation, 3: _adjust_hue}
        for code, f in draws:
            if code == 4:
                rgb = np.broadcast_to(_rgb_to_gray(rgb), rgb.shape).copy()
            else:
                rgb = np.clip(fns[code](rgb, f), 0.0, 1.0)
        return (rgb[:, ::-1] * 255.0).astype(np.float32)  # back to BGR

    def resize(self, images, intrinsics):
        """Nearest resize (torch F.interpolate semantics) + intrinsics scale
        (``augmentation.py:26-38``)."""
        sizey, sizex = self.reshape_size
        in_h, in_w = images.shape[-2], images.shape[-1]
        intrinsics = intrinsics.copy()
        intrinsics[:, [0, 2]] *= sizex / in_w
        intrinsics[:, [1, 3]] *= sizey / in_h
        if (in_h, in_w) != (sizey, sizex):
            rows = (np.arange(sizey) * in_h) // sizey
            cols = (np.arange(sizex) * in_w) // sizex
            images = images[..., rows, :][..., cols]
        return images, intrinsics

    def __call__(self, images, poses, intrinsics):
        images = self.color_transform(images)
        # Output uint8: the reference's ColorJitter operates on PIL uint8
        # images (``augmentation.py:19-24``), so its jittered pixels are
        # quantized there too; we quantize once after the (order-commuting)
        # nearest resize.  Also 4x less host->device transfer per train
        # batch — the model's in-graph cast makes uint8 input bitwise-
        # identical to feeding the same values as floats.
        from .. import native
        if native.available() and images.dtype == np.float32 \
                and images.flags.c_contiguous:
            # fused nearest-resize + round-half-even + clamp + uint8 in one
            # threaded C++ pass (the numpy path below is 4 GIL-held passes)
            sizey, sizex = self.reshape_size
            in_h, in_w = images.shape[-2], images.shape[-1]
            intrinsics = intrinsics.copy()
            intrinsics[:, [0, 2]] *= sizex / in_w
            intrinsics[:, [1, 3]] *= sizey / in_h
            out = native.resize_quantize(images, (sizey, sizex))
            if out is not None:
                return out, poses, intrinsics
            intrinsics[:, [0, 2]] /= sizex / in_w      # undo; fall through
            intrinsics[:, [1, 3]] /= sizey / in_h
        images, intrinsics = self.resize(images, intrinsics)
        images = np.clip(np.rint(images), 0, 255).astype(np.uint8)
        return np.ascontiguousarray(images), poses, intrinsics
