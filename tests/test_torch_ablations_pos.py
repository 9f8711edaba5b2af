"""PyTorch port vs the JAX package: the ViTEss ablations of the Essential
Matrix Module's positional encoding (``no_pos_encoding``: e = 64, a
192 -> 192 ``proj_fundamental`` and a 24,576-wide regressor;
``l1_pos_encoding``: the ``(1, 1, 1, y, x, 1)`` table).  The checks and
their tolerances are those of tests/test_torch_ablations.py, in a file of
their own so that the two halves run on two test workers.
"""

import pytest

from test_torch_ablations import (check_eval_forward,
                                  check_key_map_round_trip, check_one_step,
                                  config, seed_of, setup_for)

FLAGS = ["no_pos_encoding", "l1_pos_encoding"]


@pytest.fixture(scope="module", params=FLAGS)
def flag_setup(request):
    cfg = config(request.param)
    return cfg, setup_for(cfg, seed=seed_of(request.param))


def test_eval_forward_matches_jax(flag_setup):
    check_eval_forward(*flag_setup)


def test_one_step_matches_jax(flag_setup):
    check_one_step(*flag_setup)


@pytest.mark.parametrize("flag", FLAGS)
def test_key_map_round_trips(flag):
    check_key_map_round_trip(config(flag))


def test_eval_forward_without_intrinsics_matches_jax():
    """``l1_pos_encoding`` with ``intrinsics=None``: the reference's
    initial L1 table on both sides."""
    cfg = config("l1_pos_encoding")
    check_eval_forward(cfg, setup_for(cfg, seed=43), intrinsics=False)
