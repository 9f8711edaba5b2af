"""PyTorch port vs the JAX package: the microbenchmark variants of the
essential block's moments kernel (Pallas kernel #9, ``scripts/bench_cross.py``).

The Pallas bodies ``_s_kernel`` (S pairs per grid step) and
``_variant_kernel`` (modes ``mxu_sums`` and ``bf16_mul``) run in interpret
mode through a ``pl.pallas_call`` built here, because the script's
``s_call`` and ``variant_call`` hard-code TPU compiler parameters and have
no interpret switch; the script is imported with ``RELPOSE_NO_CACHE=1``, as
it enables the persistent compilation cache at import.  Their port
counterparts' plain versions (``essential_block_s`` on CPU tensors:
``essential_block_reference``; ``essential_block_variant_reference``) take
the same bf16 inputs: B = 2 pairs, N = 64, 3 heads of 64, a positional
table, from a numpy seed.  The CUDA kernels are held to the same plain
versions on the GPU (``chip_smoke.py`` phase 3f).

Tolerance: |err| <= 1e-3 max|F| -- both sides round P, vb / lc and av to
bf16 at the same points and sum in fp32 in another order, so a rounding can
move by an ulp (2^-8); measured 6.4e-4 (S = 2), 7.2e-5 (mxu_sums) and
4.9e-4 (bf16_mul).  The modes' kernels are 2.9e-3 (mxu_sums) and 1.4e-3
(bf16_mul) from #4's plain version, so the bound holds each plain version
to its own mode's rounding.
"""

import ast
import functools
import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from rel_pose_tpu_torch.ops import cross_variants as cv

REPO = pathlib.Path(__file__).resolve().parent.parent
B, N, H = 2, 64, 3
C = 64 * H
E = 70
TOL = 1e-3


@pytest.fixture(scope="module")
def bench_cross():
    mp = pytest.MonkeyPatch()
    mp.setenv("RELPOSE_NO_CACHE", "1")
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_cross", REPO / "scripts" / "bench_cross.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        mp.undo()
    return module


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(89)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for shape, scale in (((B, N, 3 * C), 1.5), ((B, N, 3 * C), 1.5),
                                 ((B, N, 6), 1.0))]


def _interpret(kernel, S, arrays):
    """``kernel`` over the pairs, S per grid step, in interpret mode."""
    qkv1, qkv2, pos = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    spec = lambda *shape: pl.BlockSpec(
        shape, lambda b: (b,) + (0,) * (len(shape) - 1))
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((B, 2, H, E, E), jnp.float32),
        grid=(B // S,),
        in_specs=[spec(S, N, 3 * C), spec(S, N, 3 * C), spec(S, N, 6)],
        out_specs=spec(S, 2, H, E, E), interpret=True)(qkv1, qkv2, pos))


def _port(arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def _max_rel(got, want):
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


def test_s_kernel_plain_version_matches_pallas(bench_cross, inputs):
    want = _interpret(functools.partial(bench_cross._s_kernel, num_heads=H,
                                        head_dim=64, S=2), 2, inputs)
    got = cv.essential_block_s(*_port(inputs), 2)
    assert got.dtype == torch.float32 and got.shape == (B, 2, H, E, E)
    assert _max_rel(got, want) <= TOL


@pytest.mark.parametrize("mode", cv.MODES)
def test_variant_plain_version_matches_pallas(bench_cross, inputs, mode):
    want = _interpret(functools.partial(bench_cross._variant_kernel,
                                        num_heads=H, head_dim=64, mode=mode),
                      1, inputs)
    got = cv.essential_block_variant(*_port(inputs), mode)
    assert got.dtype == torch.float32 and got.shape == (B, 2, H, E, E)
    assert _max_rel(got, want) <= TOL
    torch.testing.assert_close(got, cv.essential_block_variant_reference(
        *_port(inputs), mode), rtol=0, atol=0)


def test_argument_checks(inputs):
    q1, q2, pos = _port(inputs)
    with pytest.raises(ValueError, match="divide"):
        cv.essential_block_s(q1, q2, pos, 3)
    with pytest.raises(TypeError, match="bf16"):
        cv.essential_block_variant(q1.float(), q2.float(), pos, "mxu_sums")
    with pytest.raises(ValueError, match="mode"):
        cv.essential_block_variant(q1, q2, pos, "fp8")
    meta = q1.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        cv.essential_block_s(meta, meta, pos.to("meta"), 1)


def test_bench_script_imports_no_jax():
    """``scripts/bench_cross_torch.py`` runs on the GPU host, which has no
    jax: none of its imports names jax or the JAX package."""
    tree = ast.parse((REPO / "scripts" / "bench_cross_torch.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert "rel_pose_tpu_torch.ops.cross_variants" in names
    assert [n for n in names
            if n.split(".")[0] in ("jax", "jaxlib", "rel_pose_tpu")] == []
