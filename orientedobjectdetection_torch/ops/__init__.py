from .boxes import norm_angle, obb2hbb, obb2poly
from .iou import box_iou_rotated, rbbox_overlaps
from .iou_kernels import (box_iou_rotated_matrix,
                          box_iou_rotated_matrix_plain, nms_pair_mask,
                          nms_pair_mask_plain)
from .nms import multiclass_nms_rotated, nms_rotated, topk_candidates

__all__ = [
    'norm_angle', 'obb2hbb', 'obb2poly', 'box_iou_rotated', 'rbbox_overlaps',
    'box_iou_rotated_matrix', 'box_iou_rotated_matrix_plain',
    'nms_pair_mask', 'nms_pair_mask_plain', 'nms_rotated',
    'multiclass_nms_rotated', 'topk_candidates',
]
