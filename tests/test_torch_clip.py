"""PyTorch port: the training step's gradient clip
(``rel_pose_tpu_torch.train.step.clip_grad_norm``) on the CPU.

Under DDP with ``gradient_as_bucket_view`` each gradient is a view into a
flat bucket, most of them off a 16-byte boundary, where without DDP each is
an allocation of its own.  The clip must give the same bits both ways (a
DDP world of one against one process, ``chip_smoke.py`` phase 8b), and on
gradients of their own the bits of ``torch.nn.utils.clip_grad_norm_``.
"""

import numpy as np
import pytest
import torch

from rel_pose_tpu_torch.train.step import clip_grad_norm

# parameter sizes with odd counts, so that the views after them in a flat
# bucket start off a 16-byte boundary
SHAPES = [(3,), (64, 5), (7,), (192, 576), (1,), (33, 17), (576,)]


def _params(seed, scale):
    rng = np.random.default_rng(seed)
    ps = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    for p in ps:
        p.grad = torch.from_numpy(
            (scale * rng.standard_normal(p.shape)).astype(np.float32))
    return ps


def _bucketed(ps):
    """The same gradients as views into one flat buffer, DDP's layout."""
    flat = torch.cat([p.grad.reshape(-1) for p in ps])
    out, off = [], 0
    for p in ps:
        q = torch.nn.Parameter(torch.zeros_like(p))
        q.grad = flat[off:off + p.numel()].view(p.shape)
        off += p.numel()
        out.append(q)
    return out, flat


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_clip_is_torchs_on_own_gradients(scale):
    """Gradients of their own: the bits of ``clip_grad_norm_``."""
    a, b = _params(0, scale), _params(0, scale)
    na = clip_grad_norm(a, 2.5)
    nb = torch.nn.utils.clip_grad_norm_(b, 2.5)
    assert torch.equal(na, nb)
    for p, q in zip(a, b):
        assert torch.equal(p.grad, q.grad)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_clip_does_not_depend_on_the_layout(scale):
    """Bucket views off a 16-byte boundary clip to the bits of gradients
    of their own, in place in the bucket."""
    own = _params(1, scale)
    views, flat = _bucketed(_params(1, scale))
    assert any(q.grad.data_ptr() % 16 for q in views)
    n_own = clip_grad_norm(own, 2.5)
    n_views = clip_grad_norm(views, 2.5)
    assert torch.equal(n_own, n_views)
    for p, q in zip(own, views):
        assert torch.equal(p.grad, q.grad)
    assert torch.equal(flat, torch.cat([p.grad.reshape(-1) for p in own]))
