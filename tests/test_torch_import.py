"""Checkpoint-importer validation: truncated / wrong-variant / mangled
state_dicts must fail loudly with actionable reports (instead of producing a
partial params tree that dies later inside ``model.apply``).

The reference loads tolerantly and silently (``models/PWCNet.py:497-520``,
``train.py:142-154``); here strict validation is the default with
``strict=False`` as the escape hatch.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import numpy as np
import pytest
import torch

from opticalflow_tpu.models.torch_import import (
    expected_param_shapes, import_state_dict)
from oracles.torch_pwcnet import OraclePWC


@pytest.fixture(scope="module")
def sd_new():
    torch.manual_seed(0)
    return OraclePWC(variant="new").state_dict_flat()


def test_complete_state_dict_passes(sd_new):
    params = import_state_dict(sd_new, variant="new")
    assert set(params) == set(expected_param_shapes("new"))


def test_truncated_state_dict_reports_missing(sd_new):
    sd = {k: v for k, v in sd_new.items() if not k.startswith("conv3a.")}
    with pytest.raises(ValueError) as ei:
        import_state_dict(sd, variant="new")
    msg = str(ei.value)
    assert "missing keys" in msg
    assert "conv3a.0.weight" in msg and "conv3a.0.bias" in msg


def test_unparseable_and_extra_keys_reported(sd_new):
    sd = dict(sd_new)
    sd["running_stats.mean"] = np.zeros(3, np.float32)   # unparseable
    sd["conv_bogus.0.weight"] = np.zeros((3, 3, 3, 3), np.float32)
    with pytest.raises(ValueError) as ei:
        import_state_dict(sd, variant="new")
    msg = str(ei.value)
    assert "unexpected keys" in msg
    assert "running_stats.mean" in msg and "conv_bogus.0.weight" in msg


def test_wrong_variant_rejected():
    torch.manual_seed(0)
    sd_old = OraclePWC(variant="old").state_dict_flat()
    # old pyramid has no conv*aa layers → loading as "new" reports them
    with pytest.raises(ValueError, match="conv1aa"):
        import_state_dict(sd_old, variant="new")


def test_shape_mismatch_reported(sd_new):
    sd = dict(sd_new)
    sd["predict_flow2.weight"] = torch.zeros(2, 7, 3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        import_state_dict(sd, variant="new")


def test_strict_false_tolerates_everything(sd_new):
    sd = {k: v for k, v in sd_new.items() if not k.startswith("conv3a.")}
    params = import_state_dict(sd, variant="new", strict=False)
    assert "conv3a" not in params and "conv2a" in params


def test_dead_deconv2_is_not_an_error(sd_new):
    # real reference checkpoints carry the never-applied deconv2 module
    sd = dict(sd_new)
    sd["deconv2.weight"] = torch.zeros(2, 2, 4, 4)
    sd["deconv2.bias"] = torch.zeros(2)
    params = import_state_dict(sd, variant="new")  # no raise
    assert "deconv2" not in params


def test_expected_shapes_track_md():
    # md is a hyperparameter: corr channels (2md+1)² feed the L6 estimator
    assert expected_param_shapes("new", md=2)["conv6_0"]["kernel"][2] == 25
    assert expected_param_shapes("new", md=4)["conv6_0"]["kernel"][2] == 81
