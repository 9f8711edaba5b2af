"""Gradient triangulation: the kernel path's gradient against the plain
path's, both measured against a near-exact reference, leaf by leaf.

Counterpart of ``rel_pose_tpu/utils/gradcheck.py``, over ``{name: tensor
or ndarray}`` dicts keyed by state-dict names (in place of ``keystr``
paths), with the same float64 numpy arithmetic.  Used by
``tools/check_grads.py`` on the card and by ``chip_smoke.py`` phase 9d.

The kernel path ("fused") must not be farther from the reference than the
plain path at the same dtype ("stock") is, on each leaf, with headroom: a
transcription fault perturbs particular leaves far beyond the rounding
noise the plain path shows on those leaves, which a bound over all leaves
would miss on the cancellation-dominated BatchNorm leaves.

Per leaf, in float64 on the host:

- ``normrel`` = ||a - b|| / ||b||, the norm-weighted relative error;
- ``cosine`` = <a, b> / (||a|| ||b||), the direction Adam consumes.

A leaf whose reference norm is below ``zero_floor`` x the largest leaf
norm (an analytically zero gradient: a conv bias before a BatchNorm)
carries only rounding noise: its denominator is floored there and its
cosine gate skipped.
"""

import numpy as np


def _f64(v):
    if hasattr(v, "detach"):           # a torch tensor, any dtype or device
        import torch
        return v.detach().to("cpu", torch.float64).numpy()
    return np.asarray(v, dtype=np.float64)


def leaf_metrics(g_test, g_ref, zero_floor=1e-4):
    """``[(name, normrel, cosine, ref_negligible)]`` of each leaf of
    ``g_test`` against the same name in ``g_ref``, in ``g_test``'s
    order."""
    names = list(g_test)
    test = [_f64(g_test[n]) for n in names]
    ref = [_f64(g_ref[n]) for n in names]
    gscale = max(float(np.linalg.norm(r)) for r in ref)
    out = []
    for n, a, b in zip(names, test, ref):
        bn = float(np.linalg.norm(b))
        negligible = bn < zero_floor * gscale
        denom = max(bn, zero_floor * gscale)
        normrel = float(np.linalg.norm(a - b)) / denom
        an = float(np.linalg.norm(a))
        if an * bn > 0:
            cosine = float(np.dot(a.ravel(), b.ravel())) / (an * bn)
        else:
            cosine = 1.0 if an == bn else 0.0
        out.append((n, normrel, cosine, negligible))
    return out


def triangulate(g_fused, g_stock, g_ref, *, headroom=3.0, normrel_tol,
                cos_min, zero_floor=1e-4):
    """Gate the fused gradient against the stock one, leaf by leaf.

    A leaf passes iff
      normrel_fused <= max(headroom * normrel_stock, normrel_tol)
    and, unless its reference norm is negligible,
      1 - cosine_fused <= max(headroom * (1 - cosine_stock), 1 - cos_min).

    Returns ``(ok, failures, fused_rows, stock_rows)``, the rows sorted by
    the fused normrel, largest first (ties in leaf order)."""
    fused = leaf_metrics(g_fused, g_ref, zero_floor)
    stock = leaf_metrics(g_stock, g_ref, zero_floor)
    failures = []
    for (n, nr_f, cos_f, negl), (_, nr_s, cos_s, _) in zip(fused, stock):
        gate = max(headroom * nr_s, normrel_tol)
        if nr_f > gate:
            failures.append(f"{n}: normrel {nr_f:.3e} > gate {gate:.3e} "
                            f"(stock {nr_s:.3e})")
        cos_gate = max(headroom * (1.0 - cos_s), 1.0 - cos_min)
        if not negl and (1.0 - cos_f) > cos_gate:
            failures.append(f"{n}: cosine {cos_f:.6f} deficit > gate "
                            f"{cos_gate:.3e} (stock cos {cos_s:.6f})")
    order = sorted(range(len(fused)), key=lambda i: -fused[i][1])
    fused_rows = [fused[i] for i in order]
    stock_rows = [stock[i] for i in order]
    return not failures, failures, fused_rows, stock_rows


def report(tag, rows, k=5, log=print):
    log(f"  {tag} (top-{k} by normrel):")
    for n, nr, cos, negl in rows[:k]:
        z = " [~0 grad]" if negl else ""
        log(f"    normrel={nr:9.3e} cos={cos:9.6f}  {n}{z}")
