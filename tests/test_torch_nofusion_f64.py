"""The float64 check of tests/test_torch_nofusion.py: the no-fusion
baseline's one-step gradients of both packages in float64 (every fp32 cast
made float64, in the child process of tests/test_torch_train.py) agree to
1e-9, so the trunk's fp32 gap that file bounds is rounding.  A file of its
own, so that the child runs beside the other files on another test worker.
"""

import pytest

from test_torch_train import (assert_float64_gradients_agree,
                              float64_gradient_errors)


def test_one_step_gradients_match_jax_float64():
    assert_float64_gradients_agree(float64_gradient_errors("nofusion"), 56)


def test_unknown_case_fails_the_child():
    """A name the child does not know fails it, rather than falling into
    another configuration's branch."""
    with pytest.raises(AssertionError, match="unknown float64 case"):
        float64_gradient_errors("no_such_case")
