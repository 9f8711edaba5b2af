"""SE(3) geometry and the geodesic loss (W-last quaternions), with the JAX
package's exports (``rel_pose_tpu/geom/__init__.py``)."""

from .epipolar import (
    compute_correspond_epilines,
    essential_from_pose,
    fundamental_from_essential,
)
from .lie import (
    se3_compose,
    se3_exp,
    se3_identity,
    se3_identity_like,
    se3_inverse,
    se3_log,
    so3_exp,
    so3_log,
)
from .losses import geodesic_loss
from .quaternion import (
    geodesic_angle_from_matrices,
    matrix_to_quat,
    quat_conjugate,
    quat_multiply,
    quat_rotate,
    quat_to_matrix,
    rotation_from_viewpoint,
)

__all__ = [
    "quat_multiply", "quat_conjugate", "quat_rotate", "quat_to_matrix",
    "matrix_to_quat", "rotation_from_viewpoint",
    "geodesic_angle_from_matrices",
    "se3_identity", "se3_identity_like", "se3_compose", "se3_inverse",
    "se3_log", "se3_exp", "so3_log", "so3_exp",
    "geodesic_loss",
    "essential_from_pose", "fundamental_from_essential",
    "compute_correspond_epilines",
]
