"""Draw a pose's epipolar geometry on the Matterport demo pair.

    python -m rel_pose_tpu_torch.cli.generate_epipolar_imgs [--device cpu]

Counterpart of the JAX package's ``generate_epipolar_imgs.py``, with its
hard-coded inputs: from the working directory it reads
``demo/matterport_{1,2}.png`` and writes
``demo/matterport_1_epipolar_points.png`` (a 3x3 grid of coloured dots) and
``demo/matterport_2_epipolar_lines.png`` (each dot's epipolar line,
blended onto image 2).  The pose is conjugated by a rotation of pi about x
(the habitat to OpenCV convention); E = [t]x R and F = K^-T E K^-1 are
computed in float32, as the JAX script computes them, on ``--device``
(``cuda``, the default, or ``cpu``); OpenCV draws.  Each line's end points
are ``int`` truncations of its intercept and slope.
"""

import argparse
import sys

import numpy as np
import torch

from ..geom.epipolar import (compute_correspond_epilines,
                             epiline_slope_intercept, essential_from_pose,
                             fundamental_from_essential)
from ..geom.quaternion import matrix_to_quat, quat_to_matrix
from ._eval import add_device_flag, resolve_device

### start inputs
curr_path1 = "demo/matterport_1.png"
curr_path2 = "demo/matterport_2.png"
# format x,y,z,qx,qy,qz,qw
rel_pose_input = np.array([2.17275, 0.1722, -0.87071, 0.00044, 0.54702,
                           0.10733, 0.83021])

out_path1_points = "demo/matterport_1_epipolar_points.png"
out_path2_lines = "demo/matterport_2_epipolar_lines.png"

INTRINSICS = np.array([[517.97, 0, 320],
                       [0, 517.97, 240],
                       [0, 0, 1]], dtype=np.float64)

radius = 20
line_width = 15
epipolar_points_x = 3
epipolar_points_y = 3
### end inputs

colors = [
    np.array([197, 27, 125]),        # pink
    np.array([215, 48, 39]),         # red
    np.array([252, 141, 89]) - 60,   # light_orange
    np.array([175, 141, 195]),       # light_purple
    np.array([145, 191, 219]),       # light_blue
    np.array([161, 215, 106]) + 20,  # light_green
    np.array([77, 146, 33]) + 20,    # green
    np.array([118, 42, 131]) + 20,   # purple
    np.array([240, 10, 20]),         # red
]

startx = -1 + 2 / (epipolar_points_x + 1)
stopx = 1
stepx = 2 / (epipolar_points_x + 1)
starty = -1 + 2 / (epipolar_points_y + 1)
stopy = 1
stepy = 2 / (epipolar_points_y + 1)


def _f32(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def conjugate_by_x_rotation(pose, device, theta=np.pi):
    """pose' = T^-1 pose T with T = rot_x(theta) as 4x4 (float64 on the
    host; the quaternion's matrix and back in float32)."""
    T = np.eye(4)
    T[:3, :3] = np.array([
        [1, 0, 0],
        [0, np.cos(theta), -np.sin(theta)],
        [0, np.sin(theta), np.cos(theta)],
    ])
    M = np.eye(4)
    M[:3, :3] = quat_to_matrix(_f32(pose[3:], device)).cpu().numpy()
    M[:3, 3] = pose[:3]
    M2 = np.linalg.inv(T) @ M @ T
    out = np.zeros(7)
    out[3:] = matrix_to_quat(M2[:3, :3])
    out[:3] = M2[:3, 3]
    return out


def get_epipolar(point_h, pose, device):
    """A homogeneous point (3,) of image 1 and a 7-D pose -> the slope and
    intercept of its epipolar line in image 2."""
    E = essential_from_pose(_f32(pose, device))
    K = _f32(INTRINSICS, device)
    F = fundamental_from_essential(E, K, K)
    line = compute_correspond_epilines(_f32(point_h[None], device), F)[0]
    m, b = epiline_slope_intercept(line)
    return float(m), float(b)


def grid():
    """The grid's (y1, y2) in [-1, 1], row by row."""
    return [(y1, y2) for y1 in np.arange(startx, stopx, stepx)
            for y2 in np.arange(starty, stopy, stepy)]


def color_for(y1, y2):
    pctx = (y1 - startx) / (stopx - startx)
    pcty = (y2 - starty) / (stopy - starty)
    idx = int(pctx * (epipolar_points_x - 1) * epipolar_points_x
              + pcty * epipolar_points_y)
    c = colors[idx]
    return (int(c[0]), int(c[1]), int(c[2]))


def epipolar_lines(shape, device):
    """[(y1, y2, slope, intercept)] of the grid's points on an image of
    ``shape`` (H, W, ...), the pose conjugated first."""
    rel_pose = conjugate_by_x_rotation(np.copy(rel_pose_input), device)
    out = []
    for y1, y2 in grid():
        y = np.array([(y1 + 1) / 2 * shape[1], (y2 + 1) / 2 * shape[0], 1.0])
        out.append((y1, y2) + get_epipolar(y, rel_pose, device))
    return out


def main(argv=None):
    import cv2
    parser = argparse.ArgumentParser(
        prog="python -m rel_pose_tpu_torch.cli.generate_epipolar_imgs")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(
        args.device, "python -m rel_pose_tpu_torch.cli.generate_epipolar_imgs")

    # dots on image 1
    image_bg = cv2.imread(curr_path1)
    if image_bg is None:
        raise SystemExit(f"cannot read {curr_path1}")
    for y1, y2 in grid():
        y1_img = int((y1 + 1) / 2 * image_bg.shape[1])
        y2_img = int((y2 + 1) / 2 * image_bg.shape[0])
        cv2.circle(image_bg, (y1_img, y2_img), radius, color_for(y1, y2), -1)
    cv2.imwrite(out_path1_points, image_bg)

    # epipolar lines on image 2
    image_bg = cv2.imread(curr_path2)
    if image_bg is None:
        raise SystemExit(f"cannot read {curr_path2}")
    image_bg = np.array(image_bg)
    image_epipolar = image_bg * 0
    img_width = image_bg.shape[1]
    for y1, y2, m, b in epipolar_lines(image_bg.shape, device):
        x0, y0 = 0, int(b)
        x_end, y_end = int(img_width), int(b + m * img_width)
        cv2.line(image_epipolar, (x0, y0), (x_end, y_end), color_for(y1, y2),
                 line_width)

    image = cv2.addWeighted(image_epipolar, 0.6, image_bg, 0.8, 0)
    cv2.imwrite(out_path2_lines, image)
    print("wrote", out_path1_points, "and", out_path2_lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
