"""Port parity, one whole-detector SGD step of prototype4 with frozen
BatchNorm (``make_train_step`` with ``norm_eval=True``, the setting
``train_detector`` reads from every ``configs/jy/`` config), against the
JAX package's jitted step: the test, cut and tolerances of
``tests/test_torch_live_bn.py`` (loss terms at rtol 1e-4, each parameter's
change within 2e-3 of that tensor's largest change in JAX plus 2 float32
ulps of its largest value, more than 85% of the tensors moved by the
gradient, every running statistic unchanged)."""

import pytest

from test_torch_live_bn import (run_step,  # noqa: F401 (collected)
                                test_train_step_matches_jax)


@pytest.fixture(scope='module')
def stepped():
    return run_step(True)
