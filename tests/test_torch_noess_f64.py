"""The float64 check of tests/test_torch_noess.py: the --noess model's
one-step gradients of both packages in float64 (every fp32 cast made
float64, in the child process of tests/test_torch_train.py) agree to 1e-9,
so the trunk's fp32 gap that file bounds is rounding.  A file of its own,
so that the child's minute runs beside the other files on another test
worker.
"""

from test_torch_train import (assert_float64_gradients_agree,
                              float64_gradient_errors)


def test_one_step_gradients_match_jax_float64():
    assert_float64_gradients_agree(float64_gradient_errors("noess"), 83)
