"""The port's training step with an ARKitScenes scene against the JAX
package's, as a whole, on the CPU in fp32, the way
``tests/test_torch_train_slice.py`` holds the axis-aligned step (its
``run_both`` and its checks): a MultiScan scene and an ARKitScenes scene
whose GT boxes carry a yaw drawn in [-pi, pi), so that the rotated DIoU
loss, the rotated matcher costs and the decoder's rotated box decode all
reach the loss and the gradients.
"""
import numpy as np
import pytest

from tests.test_torch_train_slice import _sample, run_both
from tests.test_torch_train_slice import (
    test_train_step_draws_the_same_queries as _check_queries,
    test_train_step_gradients_match_by_name as _check_gradients,
    test_train_step_loss_matches as _check_loss,
    test_train_step_updates_batch_stats_like_jax as _check_batch_stats,
)


@pytest.fixture(scope="module")
def both():
    return run_both([_sample(1, 2, 17), _sample(2, 5, 17, rotated=True)])


def test_rotated_collate_matches_jax(both):
    for name in both["gt"]._fields:
        np.testing.assert_array_equal(getattr(both["gt"], name),
                                      np.asarray(getattr(both["jgt"], name)), err_msg=name)
    yaw = both["gt"].boxes[1, :12, 6]
    assert np.abs(yaw).min() > 0 and np.all(both["gt"].boxes[0, :, 6] == 0)
    np.testing.assert_array_equal(both["batch"].dataset_ids, [2, 5])


def test_rotated_train_step_draws_the_same_queries(both):
    _check_queries(both)


def test_rotated_train_step_loss_matches(both):
    _check_loss(both)


def test_rotated_train_step_gradients_match_by_name(both):
    _check_gradients(both)
    # The box head's two angle outputs are read by rotated scenes only: their
    # gradient comes from the rotated loss.
    assert both["grads"]["decoder.box_fc.bias"][6:].abs().min() > 0


def test_rotated_train_step_updates_batch_stats_like_jax(both):
    _check_batch_stats(both)
