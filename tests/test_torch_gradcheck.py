"""The port's gradient triangulation (``rel_pose_tpu_torch.utils.
gradcheck``) against the JAX package's (``rel_pose_tpu.utils.gradcheck``).

The same seeded arrays (leaves of a few shapes and scales, one of them an
analytically-zero gradient whose reference norm is below the zero floor)
go through both packages' ``leaf_metrics`` and ``triangulate``: the JAX
side as a dict pytree (its ``keystr`` paths are ``['name']``), the port's
as ``{name: tensor}``.  Rows must agree to 1e-12 (the same float64 numpy
arithmetic; only the summation of the norms could differ) in the same
order, and the verdicts must be equal.  A leaf with a planted 1e-2
relative perturbation in the fused gradient fails both.
"""

import numpy as np
import pytest
import torch

from rel_pose_tpu.utils import gradcheck as jgradcheck
from rel_pose_tpu_torch.utils import gradcheck

SHAPES = {"a.weight": (16, 8), "b.bias": (16,), "c.weight": (4, 3, 5, 5),
          "d.zero_bias": (8,), "e.scale": (1,)}
GATES = dict(headroom=3.0, normrel_tol=5e-3, cos_min=0.999)


def grads(seed, planted=None):
    """(reference, stock, fused) as {name: float32 ndarray}: stock and
    fused the reference plus noise of 1e-4 and 2e-4 relative; ``planted``
    gets 1e-2 in the fused one."""
    rng = np.random.default_rng(seed)
    ref = {n: rng.standard_normal(s) * (1e-9 if "zero" in n else 1.0)
           for n, s in sorted(SHAPES.items())}
    out = [ref]
    for scale in (1e-4, 2e-4):
        out.append({n: v + scale * np.linalg.norm(v) / np.sqrt(v.size)
                    * rng.standard_normal(v.shape) for n, v in ref.items()})
    if planted:
        v = ref[planted]
        out[2][planted] = v + 1e-2 * np.linalg.norm(v) / np.sqrt(v.size) \
            * rng.standard_normal(v.shape)
    return [{n: v.astype(np.float32) for n, v in g.items()} for g in out]


def _rows_equal(ours, theirs):
    assert [r[0] for r in ours] == [r[0][2:-2] for r in theirs]
    for (_, nr, cos, negl), (_, jnr, jcos, jnegl) in zip(ours, theirs):
        assert abs(nr - jnr) <= 1e-12 * max(1.0, jnr)
        assert abs(cos - jcos) <= 1e-12
        assert negl == jnegl


@pytest.mark.parametrize("planted", [None, "a.weight", "c.weight"])
def test_triangulation_matches_jax(planted):
    ref, stock, fused = grads(3, planted)
    tensors = [{n: torch.from_numpy(v) for n, v in g.items()}
               for g in (fused, stock, ref)]
    ours = gradcheck.triangulate(*tensors, **GATES)
    theirs = jgradcheck.triangulate(fused, stock, ref, **GATES)
    assert ours[0] == theirs[0] == (planted is None)
    assert len(ours[1]) == len(theirs[1])
    if planted:
        assert ours[1] and all(f.startswith(planted) for f in ours[1])
    for a, b in zip(ours[2:], theirs[2:]):
        _rows_equal(a, b)
    # leaf_metrics alone, and the analytically-zero leaf flagged
    rows = gradcheck.leaf_metrics(tensors[1], tensors[2])
    _rows_equal(rows, jgradcheck.leaf_metrics(stock, ref))
    assert [n for n, *_, negl in rows if negl] == ["d.zero_bias"]


def test_bfloat16_tensors_are_read_in_float64():
    ref = {"w": torch.randn(32, 32)}
    test = {"w": ref["w"].to(torch.bfloat16)}
    (_, nr, cos, _), = gradcheck.leaf_metrics(test, ref)
    assert 0 < nr < 2 ** -8 and cos > 0.9999


def test_report_prints_the_top_rows(capsys):
    rows = [("x", 0.5, 0.9, False), ("y", 0.1, 1.0, True)]
    gradcheck.report("fused", rows, k=5)
    out = capsys.readouterr().out
    assert "fused (top-5 by normrel)" in out
    assert "normrel=5.000e-01" in out and "y [~0 grad]" in out
