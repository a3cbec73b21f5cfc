from .boxes import (hbb2obb, norm_angle, obb2hbb, obb2poly, obb2xyxy,
                    poly2obb)
from .feature_align import (align_conv_sample, bilinear_sample,
                            deform_conv_sample, rotated_feature_align)
from .iou import box_iou_rotated, diff_iou_rotated_2d, rbbox_overlaps
from .iou_kernels import (box_iou_rotated_matrix,
                          box_iou_rotated_matrix_plain, nms_pair_mask,
                          nms_pair_mask_plain)
from .nms import (aug_multiclass_nms_rotated, batched_nms_hbb, hbb_overlaps,
                  multiclass_nms_rotated, nms_hbb, nms_rotated,
                  nms_rotated_np, topk_candidates)
from .roi_align_kernels import (roi_align_rotated_pyramid,
                                roi_align_rotated_pyramid_plain)
from .roi_align_rotated import roi_align_rotated

__all__ = [
    'norm_angle', 'obb2hbb', 'obb2poly', 'obb2xyxy', 'hbb2obb', 'poly2obb',
    'box_iou_rotated', 'diff_iou_rotated_2d', 'rbbox_overlaps',
    'box_iou_rotated_matrix', 'box_iou_rotated_matrix_plain',
    'nms_pair_mask', 'nms_pair_mask_plain', 'nms_rotated',
    'multiclass_nms_rotated', 'topk_candidates', 'hbb_overlaps', 'nms_hbb',
    'batched_nms_hbb', 'nms_rotated_np', 'aug_multiclass_nms_rotated',
    'roi_align_rotated', 'roi_align_rotated_pyramid',
    'roi_align_rotated_pyramid_plain', 'bilinear_sample',
    'rotated_feature_align', 'align_conv_sample', 'deform_conv_sample',
]
