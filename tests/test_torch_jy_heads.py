"""Port parity, the jy head variants and their losses: the MSDCN head
(deformable towers; the taps permuted to the JAX package's tap-major
order) and the decoupled-objectness heads (``RotatedDecoupledObjHead``,
``RotatedDecoupledBGHead`` and ``RotatedDecoupled1x1ObjHead``, whose
outputs are 4-tuples and whose decode gates the class logits by
``log_sigmoid(obj)``): forward, the assignment, loss, its gradient at the
outputs and ``get_bboxes``, with the tests and tolerances of
``tests/test_torch_yolov8.py`` (the losses are in
``tests/test_torch_yolov8_losses.py``)."""

import pytest
import torch

from test_torch_yolov8 import (make_head_case,  # noqa: F401 (collected)
                               test_assigner_matches_jax,
                               test_get_bboxes_matches_jax,
                               test_head_forward_matches_jax,
                               test_head_loss_gradient_matches_jax,
                               test_head_loss_matches_jax)

torch.set_num_threads(1)


@pytest.fixture(scope='module', params=[
    'RotatedMSDCNHead', 'RotatedDecoupledObjHead', 'RotatedDecoupledBGHead',
    'RotatedDecoupled1x1ObjHead'], ids=['msdcn', 'obj', 'bg', 'obj1x1'])
def head_case(request):
    case = make_head_case(request.param)
    if request.param != 'RotatedMSDCNHead':
        assert len(case['pout']) == 4
    return case


def test_objectness_head_losses_name_their_terms(head_case):
    """The decoupled heads report the objectness loss under loss_cls."""
    got = head_case['phead'].loss(head_case['pout'], *(
        torch.from_numpy(v) for v in head_case['gts']))
    assert sorted(got) == ['loss_bbox', 'loss_cls']
