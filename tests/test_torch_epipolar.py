"""The port's epipolar geometry and tool against the JAX package's, on the
CPU.

  * ``geom.epipolar`` (``skew``, ``essential_from_pose``,
    ``fundamental_from_essential``, ``compute_correspond_epilines``,
    ``epiline_slope_intercept``) and ``geom.quaternion``'s
    ``quat_to_matrix`` / ``geodesic_angle_from_matrices`` against the JAX
    functions on the same seeded float32 inputs, batched: within float32
    rounding, rtol 1e-5 (atol 1e-6 for entries near 0) [measured: skew and
    quat_to_matrix equal, the others within 2.4e-7 absolute, 1.7e-7
    relative]; each keeps its input's dtype (float64 in, float64 out).
  * ``cli.generate_epipolar_imgs`` against the JAX ``generate_epipolar_imgs.py``
    (a subprocess in its own working directory, as tests/test_cli.py runs
    it) on the same synthetic 480x640 PNGs: both output PNGs bit for bit.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import cv2

from rel_pose_tpu.geom import epipolar as jep
from rel_pose_tpu.geom import quaternion as jq
from rel_pose_tpu_torch.cli import generate_epipolar_imgs as port_tool
from rel_pose_tpu_torch.geom import epipolar as tep
from rel_pose_tpu_torch.geom import quaternion as tq
from test_cli import REPO, run_cli

RNG = np.random.default_rng(97)
OUTPUTS = ("matterport_1_epipolar_points.png",
           "matterport_2_epipolar_lines.png")


def unit_quats(n):
    q = RNG.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def poses(n):
    return np.concatenate([RNG.standard_normal((n, 3)).astype(np.float32),
                           unit_quats(n)], axis=-1)


def intrinsics(n):
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = RNG.uniform(100, 600, n)
    k[:, 0, 2], k[:, 1, 2] = RNG.uniform(100, 320, n), RNG.uniform(80, 240, n)
    k[:, 2, 2] = 1
    return k


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_skew_matches_jax():
    t = RNG.standard_normal((5, 3)).astype(np.float32)
    close(tep.skew(torch.from_numpy(t)), jep.skew(jnp.asarray(t)))


def test_essential_from_pose_matches_jax():
    p = poses(6)
    close(tep.essential_from_pose(torch.from_numpy(p)),
          jep.essential_from_pose(jnp.asarray(p)))


def test_fundamental_from_essential_matches_jax():
    E = np.array(jep.essential_from_pose(jnp.asarray(poses(6))))
    K1, K2 = intrinsics(6), intrinsics(6)
    got = tep.fundamental_from_essential(
        torch.from_numpy(E), torch.from_numpy(K1), torch.from_numpy(K2))
    want = jep.fundamental_from_essential(jnp.asarray(E), jnp.asarray(K1),
                                          jnp.asarray(K2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(want)).max())


def test_epilines_and_slope_intercept_match_jax():
    F = RNG.standard_normal((3, 3, 3)).astype(np.float32)
    pts = np.concatenate([RNG.uniform(0, 640, (3, 9, 2)),
                          np.ones((3, 9, 1))], axis=-1).astype(np.float32)
    lines = tep.compute_correspond_epilines(torch.from_numpy(pts),
                                            torch.from_numpy(F))
    want = jep.compute_correspond_epilines(jnp.asarray(pts), jnp.asarray(F))
    close(lines, want)
    np.testing.assert_allclose(
        np.hypot(lines[..., 0].numpy(), lines[..., 1].numpy()), 1, rtol=1e-6)
    for got, w in zip(tep.epiline_slope_intercept(torch.from_numpy(
            np.array(want))), jep.epiline_slope_intercept(want)):
        close(got, w)


def test_zero_line_is_left_as_is():
    """F p = 0 gives the zero line, not NaN (the normalizer's
    ``where``)."""
    F = torch.zeros(3, 3)
    out = tep.compute_correspond_epilines(torch.ones(1, 3), F)
    assert torch.equal(out, torch.zeros(1, 3))


def test_quat_to_matrix_matches_jax():
    q = unit_quats(8)
    close(tq.quat_to_matrix(torch.from_numpy(q)),
          jq.quat_to_matrix(jnp.asarray(q)))


def test_geodesic_angle_matches_jax():
    m1 = np.asarray(jq.quat_to_matrix(jnp.asarray(unit_quats(8))))
    m2 = np.asarray(jq.quat_to_matrix(jnp.asarray(unit_quats(8))))
    close(tq.geodesic_angle_from_matrices(torch.from_numpy(m1),
                                          torch.from_numpy(m2)),
          jq.geodesic_angle_from_matrices(jnp.asarray(m1), jnp.asarray(m2)))
    eye = torch.eye(3).expand(8, 3, 3)
    assert torch.equal(tq.geodesic_angle_from_matrices(eye, eye),
                       torch.zeros(8))


@pytest.mark.parametrize("fn,arg", [
    (tq.quat_to_matrix, lambda: unit_quats(2)),
    (tep.skew, lambda: RNG.standard_normal((2, 3))),
    (tep.essential_from_pose, lambda: poses(2)),
])
def test_functions_keep_their_dtype(fn, arg):
    x = torch.from_numpy(np.asarray(arg(), np.float64))
    assert fn(x).dtype == torch.float64


def test_epipolar_lines_grid_and_conjugation():
    """``epipolar_lines`` on the CPU: 9 lines in grid order, the pose's
    conjugation by pi about x its own inverse."""
    lines = port_tool.epipolar_lines((480, 640, 3), torch.device("cpu"))
    assert len(lines) == 9
    assert [(y1, y2) for y1, y2, _, _ in lines] == port_tool.grid()
    pose = port_tool.rel_pose_input
    back = port_tool.conjugate_by_x_rotation(
        port_tool.conjugate_by_x_rotation(pose, "cpu"), "cpu")
    np.testing.assert_allclose(back, pose, rtol=0, atol=2e-6)


def _write_demo(wd, images):
    os.makedirs(os.path.join(wd, "demo"), exist_ok=True)
    for name, img in zip(("matterport_1.png", "matterport_2.png"), images):
        cv2.imwrite(os.path.join(wd, "demo", name), img)


def test_epipolar_pngs_match_jax_bit_for_bit(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)
              for _ in range(2)]
    jax_wd, port_wd = str(tmp_path / "jax"), str(tmp_path / "port")
    _write_demo(jax_wd, images)
    _write_demo(port_wd, images)
    r = run_cli([os.path.join(REPO, "generate_epipolar_imgs.py")],
                cwd=jax_wd)
    assert r.returncode == 0, r.stderr[-3000:]
    monkeypatch.chdir(port_wd)
    assert port_tool.main(["--device", "cpu"]) == 0
    assert "wrote demo/matterport_1_epipolar_points.png" in \
        capsys.readouterr().out
    for name in OUTPUTS:
        want = cv2.imread(os.path.join(jax_wd, "demo", name))
        got = cv2.imread(os.path.join(port_wd, "demo", name))
        assert want is not None and got is not None, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert (got != images[OUTPUTS.index(name)]).any(), name


def test_epipolar_tool_refuses_cuda_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        port_tool.main([])
    assert "no CUDA device" in str(e.value)
