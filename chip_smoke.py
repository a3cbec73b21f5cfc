#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

Drives the port's main paths at full width with seeded random weights:
serving and training of Rotated RetinaNet R50-FPN le90
(configs/rotated_retinanet/rotated_retinanet_obb_r50_fpn_1x_dota_le90.py),
of Oriented R-CNN R50-FPN le90
(configs/oriented_rcnn/oriented_rcnn_r50_fpn_1x_dota_le90.py), of the
other single-stage recipes (Rotated FCOS, Rotated ATSS, KFIoU, GWD,
KLD-stable and CSL, each at its published R50-FPN DOTA config) and of the
refine detectors (S2ANet R50-FPN le135 and R3Det R50-FPN oc; the KFIoU
refine recipes and the two-stage R3Det cascade in float32) and of the
horizontal-proposal two-stage families (Rotated Faster R-CNN, Gliding
Vertex and RoI Transformer, each R50-FPN le90) and of the other backbones
and ReDet (Swin-T Oriented R-CNN le90, ConvNeXt-T KLD-stable RetinaNet le90
and ReDet ReR50-ReFPN le90) and of the point-set families (Rotated
RepPoints oc, Oriented RepPoints le135, G-RepPoints le135, SASM oc and CFA
le135, each R50-FPN) and of the RotatedYOLOv8 models (configs/jy/:
prototype4, CSPNeXt-M with the YOLOv8 PAFPN and head, trained with frozen
and with live BatchNorm; prototype3, CSPNeXt-L with MSARC; the CSPDarknet /
PAFPN_E / MSDCN-head model; the 1x1 objectness head; prototype4 with the
YOLOv6 Rep-PAFPN neck, served and trained), the YOLO block library, and
seeded prototype4 and ReDet checkpoints under the reference's names
converted back, through
``init_detector`` / ``DetectorBundle`` and ``create_train_state`` /
``make_train_step``, and holds every CUDA kernel of those paths against its
plain PyTorch version:

1. device    require a CUDA device; print its name and power limit
2. build     compile the kernels from csrc/ with nvcc, all at once (ptxas
             report)
3. kernel    nms_pair_mask vs its plain version on DOTA-like inputs
             (B=8 x N=2000, N=300, duplicates and padding); time both
4. slice     float32, 2 images of 1024^2: detections with the kernel equal
             those with the plain pair mask
5. serving   bfloat16, batch 8 of 1024^2 uint8 images: throughput, the
             split between forward and decode+NMS, peak memory, launches
6. kernel    box_iou_rotated vs its plain version at the assignment shape
             (B=8, G=32 gts x the 196,416 anchors of a 1024^2 image; IoF;
             G=128 dense gts; duplicates and zero padding; the loader's
             padding, G=512 with 64 valid); time both at G=32, the kernel
             alone at G=512
7. train     float32, 2 images: one train step with the kernel and one
   slice     from the same state with the plain IoU matrix agree
8. training  bfloat16 autocast, batch 8 of 1024^2 uint8 images, the
             config's optimizer: 3 warm + 10 timed steps, imgs/s, peak
             memory, launches per step, a falling loss, one more step
             recording the assigner's IoU-matrix inputs, one profiled step
9. kernel    roi_align_rotated vs its plain version at the Oriented R-CNN
             shape (B=8, 2000 RoIs, C=256, levels 256/128/64/32; float32 and
             bfloat16; all four levels, elongated, giant, over-the-edge and
             zero-size RoIs; both ``clockwise`` values; a small odd shape);
             time both
10. oriented float32, 2 images of 1024^2 through Oriented R-CNN: detections
    slice    with the kernels equal those with the plain RoIAlign and with
             the plain pair mask
11. oriented bfloat16, batch 8 of 1024^2 uint8 images: throughput, the split
    serving  network+RPN / proposals / RoIAlign+head / decode+NMS, peak
             memory, launches per request, profiled requests split by the
             detector's ``two_stage.*`` ranges
13. oriented float32, 2 images of 1024^2, G=32 with 8 valid: two-stage
    train    train steps from one seeded state and rng with the IoU-matrix
    slice    kernel in both assigners, in neither and in the RoI head's
             only; each assigner assigns as with the plain matrix outside
             ASSIGN_BAND, and where they agree the steps give the same
             sampled anchors and RoIs, labels and losses, and parameters
             within PARAM_RTOL of each tensor's change
14. oriented bfloat16 autocast, 1024^2 uint8 images, the config's optimizer,
    training G=32 with 8 valid: batch 8 and batch 4, 3 warm + 10 timed steps
             each, imgs/s, peak memory, two box_iou_rotated launches per
             step (the RPN's and the RoI head's assigners), a falling loss;
             at batch 8 one more step recording both assigners' IoU-matrix
             inputs and the RoI pooling's inputs, the gather pooling's
             forward and backward timed alone, and one profiled step split
             by the ``train.*`` and ``two_stage.*`` ranges, with no host
             synchronisation inside ``two_stage.rpn_targets`` or
             ``two_stage.sample_rois``
15. data     the port's generator writes a synth-hard set (16 train + 8
             val images of 1024^2, 100-600 instances each); the synth1024
             config's datasets on it; its DataLoader timed alone (uint8,
             batch 8, max_gt 512), batch shapes, every annotation kept or
             in gt_ignore, polygons that round-trip through poly2obb_np /
             obb2poly_np
16. trainer  ``train_detector`` on that config at published widths (R50-FPN,
             15 classes, 1024^2, batch 8) in bfloat16 for 20 steps with the
             evaluation and a checkpoint at the end; one box_iou_rotated
             launch a step; a resume from the checkpoint gives back the
             step and every tensor exactly, and goes on for 2 more steps;
             the loop's imgs/s against the same step alone on one loader
             batch and against phase 8; peak memory
17. eval     ``eval_from_state`` on the 8 val images (float32, the trained
             weights with the class bias zeroed); the same images with the
             kernels and with their plain versions (B1 in the NMS, B2 in
             ``eval_rbbox_map``): the same detections up to near-ties, the
             same per-class AP within AP_ATOL; the kernel run's IoU-matrix
             inputs recorded for phase 12
18. oriented ``oriented_rcnn_tiny_synth.py`` through ``train_detector`` on a
    loop     40-image tiny-synth set of 256^2: 20 bfloat16 steps with two
             box_iou_rotated launches each, then the evaluation, where
             roi_align_rotated runs; every input the run gave a kernel
             recorded for phase 12
19. patches  ``inference_detector_by_patches`` on one 4000^2 uint8 image
             (bf16, phase 5's weights): 25 windows of 1024 at step 824 in
             batches of 8, the per-class merge NMS; the wall time split into
             tile forward, tile decode + NMS and merge, the merge's N per
             class and greedy rounds, peak memory; the plain pair mask gives
             the same merged detections; the merge's inputs recorded
20. tta      ``inference_detector_tta`` on batch-1 1024^2 images: ms an
             image; the same detections with the plain pair mask
21. submis-  the tiled_eval_demo flow with the port's tools: six 1024^2
    sion     scenes, ``tools.img_split`` at 256 px with a 64 px gap,
             single-scale and with rates 0.5 / 1.0 / 2.0, ``batched_eval``
             of phase 16's weights (class bias zeroed), ``format_results``
             (15 Task1 files in a zip); ``merge_det`` with the kernels and
             with the plain pair mask the same; the original-frame mAP; the
             merge's inputs recorded
22. augment  HRSC rr (R50-FPN, ``PolyRandomRotate``) on 40 + 8 BMP scenes
             of 1024^2 (a 512^2 canvas): the loader with and without the
             rotation, a ``MultiImageMixDataset`` with ``RMosaic``,
             ``train_detector`` for 20 bf16 steps against the step alone,
             ``evaluate`` (AP50, AP75); the assigner's and the evaluations'
             IoU-matrix inputs recorded
23. fcos     configs/rotated_fcos/rotated_fcos_r50_fpn_1x_dota_le90.py:
             float32, 2 images of 1024^2, the same outputs decoded with the
             pair-mask kernel and with its plain version give the same
             detections (``same_detections``); then bfloat16 requests of 8
             images of 1024^2: imgs/s, forward / decode+NMS, peak memory,
             one pair-mask launch a request
24. fcos     bfloat16 autocast, batch 8 of 1024^2, G=32 with 8 valid: 3
    training warm + 10 timed steps, imgs/s, peak memory, finite loss
             terms (no assigner: no box_iou_rotated launch), one step at
             the loader's G=512 for its peak memory, one step profiled by
             ``train.*`` and the head's ``fcos.targets`` and
             ``fcos.box_loss`` ranges
25. anchor   ATSS, KFIoU, GWD, KLD (GDLoss_v1), KLD-stable (GDLoss) and
    recipes  CSL at their published R50 configs: a float32 step of 2
             images of 1024^2 with the IoU-matrix kernel and one with the
             plain matrix (the same assignments up to the band, losses and
             parameters within LOSS_RTOL and PARAM_RTOL), then 2 warm + 5
             timed bfloat16 steps at batch 8 (imgs/s, peak memory, one
             box_iou_rotated launch a step; ATSS also one step at the
             loader's G=512), then each served as in 23
26. family   ``rotated_fcos_tiny_synth.py`` and ``csl_tiny_synth.py``
    loops    through ``train_detector`` on phase 18's tiny-synth set: 20
             bfloat16 steps and the evaluation (B1 in its NMS, B2 in its
             IoUs and in CSL's assigner), every input recorded
27. refine   S2ANet and R3Det (their R50 DOTA configs) in float32 at 2
    slice    images of 1024^2: the same outputs decoded with the pair-mask
             kernel and with its plain version give the same detections;
             one train step with the IoU-matrix kernel and one with the
             plain matrix from one seeded state: each stage's assigner
             (the first on its anchors, the refine stage on each image's
             rois) alike up to the band, losses within LOSS_RTOL,
             parameters within PARAM_RTOL; the same for one step of the
             two KFIoU refine recipes and of the two-stage R3Det cascade
28. refine   bfloat16 requests of 8 raw 1024^2 images through each: imgs/s,
    serving  forward / decode+NMS, peak memory, one pair-mask launch a
             request; one request profiled by the ``refine.*`` ranges
             (first stage, rois, align / FRM, refine head, decode + NMS)
29. refine   bfloat16 autocast, batch 8 of 1024^2, G=32 with 8 valid: 2
    training warm + 5 timed steps, imgs/s, peak memory, two
             box_iou_rotated launches a step (the first stage's shared
             anchors, the refine stage's per-image rois); one step at the
             loader's G=512; one step profiled by ``train.*`` and
             ``refine.*`` (with each stage's targets and loss); the align
             / FRM sampling's forward and backward alone on a step's inputs
30. refine   ``s2anet_tiny_synth.py`` and ``r3det_tiny_synth.py`` through
    loops    ``train_detector`` on phase 18's set: 20 bfloat16 steps (two
             box_iou_rotated launches each) and the evaluation, every input
             recorded
31. hbb      Rotated Faster R-CNN, Gliding Vertex and RoI Transformer (their
    slice    R50 DOTA configs, regressions x 0.05) in float32 at 2 images of
             1024^2: the detections with the RoIAlign kernel equal those
             with its plain version, and with the pair-mask kernel those
             with its plain mask; one train step with the IoU-matrix kernel
             and one with the plain matrix on gts whose RPN assignment is
             decided: the RPN's and each RoI stage's assigner alike up to
             the band, losses within LOSS_RTOL, parameters within PARAM_RTOL
32. hbb      bfloat16 requests of 8 raw 1024^2 images through each: imgs/s,
    serving  forward / decode+NMS, peak memory, roi_align_rotated launches
             a request (1, 1, 2: RoI Transformer pools once a stage), one
             pair-mask launch; one RoI Transformer request profiled by the
             ``two_stage.*`` ranges, each stage's RoIAlign in its own
33. hbb      bfloat16 autocast, batch 8 of 1024^2, G=32 with 8 valid: 2
    training warm + 5 timed steps (RoI Transformer 3 + 10), imgs/s, peak
             memory, 2 / 2 / 3 box_iou_rotated launches a step and none of
             the others, a falling loss (one sampling key for every step);
             one step at the loader's G=512; one step profiled with no host
             sync inside the RPN targets or a RoI stage's sampler; RoI
             Transformer's gather pooling of each stage timed alone
34. hbb      the three tiny-synth configs through ``train_detector`` on
    loops    phase 18's set: 20 bfloat16 steps and the evaluation, every
             input recorded (the evaluation's RoIAlign inputs too)
35. back-    Swin-T Oriented R-CNN, ConvNeXt-T KLD-stable RetinaNet and
    bones    ReDet ReR50-ReFPN (their DOTA configs, regressions x 0.05) in
    slice    float32 at 2 images of 1024^2: the detections with the
             RoIAlign kernel equal those with its plain version (ReDet's
             before its orientation roll), and with the pair-mask kernel
             those with its plain mask; one train step with the IoU-matrix
             kernel and one with the plain matrix from one seeded state
             (the RetinaNet as phase 25; the two-stage detectors on gts
             whose RPN assignment is decided): losses within LOSS_RTOL,
             parameters within PARAM_RTOL (ADAM_FIRM after AdamW); ReDet
             freezes layer1 and trains its stem
36. back-    bfloat16 requests of 8 raw 1024^2 images through each: imgs/s,
    bones    forward / decode+NMS, peak memory, roi_align_rotated launches
    serving  a request (1 / 0 / 1), one pair-mask launch; one request of
             each profiled by module (``module.backbone``, ``.neck``, the
             heads, ReDet's ``two_stage.ri_roll``) with its top kernels
37. back-    bfloat16 autocast, batch 8 of 1024^2, G=32 with 8 valid, each
    bones    config's optimizer (AdamW / AdamW / SGD): 2 warm + 5 timed
    training steps, imgs/s, peak memory, 2 / 1 / 2 box_iou_rotated
             launches a step, a falling loss; one step at the loader's
             G=512; one step profiled by ``train.*``, ``two_stage.*`` and
             ``module.*`` with no host sync inside the samplers
38. redet    ``redet_tiny_synth.py`` through ``train_detector`` on phase
    loop     18's set: 20 bfloat16 steps and the evaluation, every input
             recorded
39. point    Rotated RepPoints, Oriented RepPoints and G-RepPoints (their
    sets     R50 DOTA configs, the seeded points spread on a 3 x 3 grid, the
    slice    class bias zeroed) in float32 at 2 images of 1024^2: the same
             outputs decoded with the pair-mask kernel and with its plain
             version give the same detections; for each of them, SASM and
             CFA, one step's targets computed on the card equal those the
             same code computes from the same outputs on the CPU (the
             assignments, positives, SASM's positives, CFA's and APAA's
             keeps), the losses within LOSS_RTOL, the step finite; the
             chunked convex IoU equals one whole chunk bit for bit
40. point    bfloat16 requests of 8 raw 1024^2 images through Rotated,
    sets     Oriented and G-RepPoints: imgs/s, forward / decode+NMS, peak
    serving  memory, one pair-mask launch a request and no other launch;
             one request profiled by the ``reppoints.*`` ranges (towers,
             each deformable sampling, heads, decode + NMS)
41. point    bfloat16 autocast, batch 8 of 1024^2, G=32 with 8 valid, each
    sets     config's optimizer: 2 warm + 5 timed steps of each family,
    training imgs/s, peak memory, no kernel launch (the assigners use the
             convex IoU), a falling loss; one step at the loader's G=512
             (Rotated RepPoints, SASM); one step profiled by ``train.*`` and
             ``reppoints.*`` with no host sync inside ``reppoints.targets``;
             the deformable sampling of a step alone (forward and
             backward), and Rotated RepPoints' convex IoU alone at G=32 and
             G=512
42. point    the Oriented RepPoints, SASM, CFA and G-RepPoints tiny-synth
    sets     configs through ``train_detector`` on phase 18's set: 20
    loops    bfloat16 steps and the evaluation, every input recorded
43. yolov8   prototype4 and objectness-loss3 (seeded, the class bias
    slice    zeroed) in float32, 2 images of 1024^2: detections with the
             pair-mask kernel equal those with its plain version; one
             step's assignments (labels, positives, targets) with the
             IoU-matrix kernel equal those with the plain matrix, the
             losses within LOSS_RTOL; one prototype4 step with live
             BatchNorm: finite losses, every running statistic moved, a
             stem BatchNorm's by the EMA of the biased batch variance
44. yolov8   bfloat16 requests of 8 raw 1024^2 images through prototype4
    serving  (10 timed), prototype3 and the MSDCN model (5 timed each):
             imgs/s, forward / decode+NMS, peak memory, one pair-mask
             launch a request and no other; one request profiled by
             ``module.backbone`` / ``neck`` / ``bbox_head`` and
             ``yolov8.*`` ranges
45. yolov8   bfloat16 autocast, batch 8 of 1024^2, G=32 with 8 valid,
    training prototype4 with its SGD, frozen and live BatchNorm: 2 warm +
             5 timed steps, imgs/s, peak memory, one IoU-matrix launch a
             step, a falling loss; one frozen step at the loader's G=512;
             one step profiled by ``train.*`` and ``yolov8.*`` with no host
             sync inside ``yolov8.targets``
46. yolov8   the RotatedYOLOv8 tiny-synth config through ``train_detector``
    loop     on phase 18's set: 20 bfloat16 steps and the evaluation, every
             input recorded
47. data     Rotated RetinaNet R50-FPN and prototype4 with live BN, one
    parallel float32 step (TF32 off) on a global batch of 8 of 1024^2, G=32,
    training the halves with 8 and 3 valid gts: (i) in a NCCL group of
             ``torch.cuda.device_count()`` ranks (a group of one process on
             one card) against the plain step; (ii) over two gloo
             processes sharing the card, 4 images each, each rank's step
             against one process's on all 8 (losses and grad_norm within
             1e-4, each change within 2e-3 of its largest plus 2 ulps);
             (iii) the same for prototype4 with frozen BN, and with live
             BN: the losses, and every running statistic within 1e-5 of
             its largest; grad_norm and the changes (L2) within 3 times
             what the one-process step moves when its batch is reordered
             (the float32 live-BN gradient is not determined further), and
             the same comparison refuses the live step with a fault of the
             gradient alone planted (live BN's sum across ranks without
             its backward); then RetinaNet bfloat16 steps timed a rank;
             B2's launches a rank
48. data     phases 16's and 18's models (synth1024 RetinaNet, tiny
    parallel Oriented R-CNN) evaluated over the two gloo ranks through a
    eval     ``collect_dir``: the same lists and mAP as one process;
             ``DetectorBundle(devices=[every local card])`` the one-device
             detections
49. host     ``tools.serve`` on an ephemeral localhost port answers 10 PNG
             requests (the JSON ``inference_detector``'s, ms a request); the
             native host NMS on phase 21's largest merge class keeps what
             the pair-mask kernel keeps (both timed); one request drawn by
             ``imshow_det_rbboxes``; ``confusion_matrix`` on phase 17's
             evaluation; ``get_flops`` of RetinaNet R50
50. yolov6   prototype4 with its neck replaced by the YOLOv6 Rep-PAFPN
    neck     (``YOLOV6_NECK``: 12 CSP blocks, 8 RepVGG blocks a stage):
             (i) float32, 2 images of 1024^2, detections with the pair-mask
             kernel equal those with its plain version; on gts whose
             assignment is decided, a step's targets with the IoU-matrix
             kernel equal those with the plain matrix, and a step with each
             from one seeded state the same losses and parameters; (ii)
             bfloat16 requests of 8 raw 1024^2 images, 10 timed after 3
             warm: imgs/s, forward / decode+NMS, peak memory, one pair-mask
             launch a request, one request profiled by module; (iii)
             bfloat16 autocast training at batch 8, G=32 with 8 valid, the
             config's SGD, frozen BN: 3 warm + 5 timed steps, imgs/s, peak
             memory, one IoU-matrix launch a step, a falling loss
51. blocks   each of the 38 classes of ``models/yolo_blocks.py`` (ASFF at
             each level) with seeded weights at batch 8, where a
             prototype4-width neck at 1024^2 runs it (192 channels on 128^2,
             ASFF over 128^2 / 64^2 / 32^2 at 192 / 384 / 576, PSA and the
             deformable fusions at 576 on 32^2, the text-guided blocks with
             a (8, 15, 512) guide): float32 on the card against the CPU
             within BLOCK_RTOL, then bfloat16 forward ms and peak memory
52. refer-   seeded prototype4 and ReDet written under the reference's
    ence     names (mmyolo's; e2cnn's filters and per-field BatchNorms),
    weights  converted by ``tools.convert_reference_weights`` in a
             subprocess and served by ``init_detector``: every tensor equal
             to the seeded model's, the float32 detections of 2 images of
             1024^2 equal (B1 in both, B3 in ReDet)
12. kernels  runs last: phases 3, 6 and 9 again on the inputs the main
    on the   paths gave the kernels: nms_pair_mask on the candidates of one
    main     RetinaNet request (phase 5) and of one Oriented R-CNN request
    path     (phase 11), box_iou_rotated on the assigner's gts and anchors
             of one RetinaNet train step (phase 8) and on both assigners'
             inputs of one Oriented R-CNN train step (phase 14: the RPN's
             gts against the shared anchors, the RoI head's against each
             image's proposals), roi_align_rotated on that Oriented R-CNN
             request's levels and proposals, each recorded by a wrapper put
             in place of the kernel's name for that one request or step;
             and every input phases 17 and 18 gave a kernel: the IoU
             matrices of ``eval_rbbox_map`` in both, phase 18's RPN and RoI
             assigners' matrices of each step, and its evaluation's NMS
             candidates and RoIAlign levels (C=64) and RoIs; and those of
             phases 19-22: the merges' pair masks (from N = 8192 on in
             blocks of 128 rows against the plain IoU of those rows), the
             HRSC assigner's and evaluations' IoU matrices; and those of
             phases 23-26: one FCOS and one CSL request's NMS candidates,
             one ATSS and one KFIoU train step's assigner inputs (ATSS:
             21,824 single-anchor priors as rows x the gts), the tiny
             loops' assigner, evaluation IoU and NMS inputs; and those of
             phases 27-30: the refine detectors' NMS candidates (the top
             2000 over all levels at once), their first and refine stages'
             assigner inputs (gts x each image's 21,824 rois) at G=32 and
             G=512, the float32 steps' and the tiny loops'; and those of
             phases 31-34: each family's served RoIs (theta-0 proposals,
             Faster R-CNN's at 1 sample a bin side; RoI Transformer's
             rotated stage-1 RoIs), candidates, RPN and RoI-stage assigner
             inputs at G=32 and G=512, the float32 slices' and the tiny
             loops'; and those of phases 35-38: Swin Oriented R-CNN's
             and ReDet's served and float32 RoIAlign inputs (ReDet's
             ReFPN levels, 32 fields x 8 orientations, before the roll),
             every detector's candidates, their assigners' inputs at G=32
             and G=512 and the float32 steps', ReDet's tiny loop's; and
             those of phases 39-42: the served point-set families'
             candidates (float32 slice and bfloat16 request) and the tiny
             loops' evaluation NMS and IoU inputs; and those of phases
             43-46: the YOLOv8 models' candidates, the assigner's decoded
             predictions x gts (both batched) of the float32 steps, of
             prototype4's steps at G=32 and G=512 and of the tiny loop, and
             its evaluation's; and those of phases 50-52: the YOLOv6-neck
             model's candidates and assigner inputs of its float32 slice
             and its steps, the converted models' candidates and the
             converted ReDet's RoIAlign inputs; each held against its plain
             version, the largest of each kind timed beside its bound

Every phase raises on failure. The launch counts are set to 0 just before
each main path (5, 8, 11, 14 at batch 8, 14 at batch 4, 16's first
``train_detector`` run, 17's ``eval_from_state``, 18, 19's timed image,
20's timed images, 21's evaluations and ``format_results``, 22's
``train_detector`` run and its ``evaluate``, 23's requests, 24's steps,
25's bfloat16 steps and requests of each recipe, 26's runs, 28's
requests and 29's steps of each refine detector, 30's runs, 32's
requests and 33's steps of each two-stage family, 34's runs, 36's
requests and 37's steps of each detector, 38's run, 40's requests and
41's steps of each point-set family, 42's runs, 44's requests of each
YOLOv8 model, 45's frozen and live steps, 46's run, 47's steps and 48's
evaluations in each rank, 49's requests, kernel NMS calls and confusion
matrix, 50's requests and steps, 52's requests of each model) and read
just after;
the recorded requests and steps run after that, apart from phase 18's run,
which is recorded as it is counted, as are 21's merges, 22's steps and
26's, 30's, 34's, 38's, 42's and 46's runs and 52's requests. Phases
15-22, 26, 30, 34, 38, 42, 46, 50 and 52 write
their data, configs, checkpoints and work directories under
``_data/chip_smoke/`` (gitignored). The last two lines
of standard output are one JSON object with the kernels' numbers and one
with the device: ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": 1}}``. Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'configs',
                      'rotated_retinanet',
                      'rotated_retinanet_obb_r50_fpn_1x_dota_le90.py')
ORCNN_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'configs', 'oriented_rcnn',
                            'oriented_rcnn_r50_fpn_1x_dota_le90.py')
IOU_THR = 0.1            # the config's test_cfg.nms.iou_thr
BAND = 2e-3              # mask may differ only this close to the threshold
DETS_ATOL = 1e-3
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and
# fp32 (non-tensor-core) FLOP/s, at the full 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
FLOP_PER_PAIR = 300      # the TPU kernel's cost model (iou_pallas.py:459)
FLOP_PER_IOU_PAIR = 600  # the same for the IoU matrix (iou_pallas.py:386)
# IoU matrix, kernel vs plain: sincosf and FMA contraction move an IoU by up
# to ~1e-5 (largest seen on an H100: 8.1e-6, an IoF close to 1)
IOU_ATOL = 2e-5
LOSS_RTOL = 1e-4         # train step, kernel vs plain matrix
# two-stage train step, kernel vs plain matrix: parameters after the step
# agree per tensor within PARAM_RTOL x the largest change of that tensor.
# The gather RoIAlign's backward and cuDNN's weight gradients accumulate
# with atomics in an order that changes from run to run, which moves a
# tensor whose gradient is small against its weight decay by more (5.2e-4
# seen on an H100 between two steps with equal sampled sets); the sampled
# sets and the losses themselves are held equal.
PARAM_RTOL = 1e-2
# AdamW's first step moves an element by lr * g / (|g| + 1e-8): where the
# reference gradient is under ADAM_FIRM of its tensor's largest (at the
# atomics' rounding: Swin's key bias has a gradient of 0 in exact
# arithmetic), the two steps' element changes are held only to the
# tensor's largest change, the rest to PARAM_RTOL as for SGD
ADAM_FIRM = 1e-4
# events that make the host wait for the device (a read of a device value,
# or an explicit synchronisation): none may run inside the sampler's ranges.
# cudaMemcpyAsync alone is not one (PyTorch follows a copy to the host with
# cudaStreamSynchronize).
SYNC_EVENTS = ('aten::item', 'aten::_local_scalar_dense', 'aten::nonzero',
               'cudaStreamSynchronize', 'cudaDeviceSynchronize',
               'cudaEventSynchronize', 'cudaMemcpy')
ASSIGN_BAND = 1e-5       # assignments may differ this close to a threshold
# RoIAlign, kernel vs plain, per element:
# |kernel - plain| <= ROI_RTOL x max |feature| (+ ROI_BF16_STEP x |plain| in
# bfloat16). Bilinear interpolation with masked corners is continuous in the
# sample coordinates, and sincosf and FMA contraction move a sample by ~1e-4
# cells at most, so the float32 sums agree to about 1e-4 of the feature
# range. In bfloat16 both round their float32 sum once, so where the two sums
# straddle a rounding boundary the outputs differ by one more step of that
# element, at most 2^-7 of its own magnitude.
ROI_RTOL = 2e-4
ROI_BF16_STEP = 2 ** -7
ROI_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
# Oriented R-CNN, RoIAlign kernel vs plain: pooled features that differ by
# ~1e-4 of their range move the head's logits by a few 1e-5 (2.4e-5 seen on
# an H100, logits up to 5) and a class score by less than SCORE_BAND
HEAD_ATOL = 1e-3
SCORE_BAND = 1e-4
ROOT = os.path.dirname(os.path.abspath(__file__))
SYNTH1024_CONFIG = os.path.join(ROOT, 'configs', 'rotated_retinanet',
                                'rotated_retinanet_synth1024.py')
ORCNN_TINY_CONFIG = os.path.join(ROOT, 'configs', 'oriented_rcnn',
                                 'oriented_rcnn_tiny_synth.py')
# generated data and work directories of phases 15-18 (gitignored)
DATA_DIR = os.path.join(ROOT, '_data', 'chip_smoke')
# annotation files round polygons to 0.1 px; the rectangle through them
# gives the corners back within that and the float32 arithmetic
ROUND_TRIP_ATOL = 0.15
# per-class AP, kernels vs plain versions in the evaluation
AP_ATOL = 1e-4
KERNELS = {
    'nms_pair_mask': dict(
        route='cuda', source='orientedobjectdetection_torch/csrc/'
        'nms_pair_mask.cu',
        replaces='orientedobjectdetection_tpu/ops/iou_pallas.py:399'),
    'box_iou_rotated': dict(
        route='cuda', source='orientedobjectdetection_torch/csrc/'
        'box_iou_rotated.cu',
        replaces='orientedobjectdetection_tpu/ops/iou_pallas.py:347'),
    'roi_align_rotated': dict(
        route='cuda', source='orientedobjectdetection_torch/csrc/'
        'roi_align_rotated.cu',
        replaces='orientedobjectdetection_tpu/ops/roi_align_pallas.py:226'),
}


def log(msg: str):
    print(msg, flush=True)


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def kernel_wrappers() -> dict:
    """Kernel name -> the wrapper that counts its launches."""
    from orientedobjectdetection_torch.ops.iou_kernels import (
        box_iou_rotated_matrix, nms_pair_mask)
    from orientedobjectdetection_torch.ops.roi_align_kernels import (
        roi_align_rotated_pyramid)
    return {'nms_pair_mask': nms_pair_mask,
            'box_iou_rotated': box_iou_rotated_matrix,
            'roi_align_rotated': roi_align_rotated_pyramid}


def reset_launches():
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


@contextlib.contextmanager
def recording(obj, name, keep_results=True):
    """Put a wrapper in place of ``obj.name`` (a module's function or an
    object's method) that keeps the positional arguments and the result of
    every call (the result None unless ``keep_results``: a merge's pair
    masks reach gigabytes); restore the name after. Yields the list of
    (args, result)."""
    own = name in vars(obj)
    original = getattr(obj, name)
    calls = []

    def record(*args):
        result = original(*args)
        calls.append((args, result if keep_results else None))
        return result

    # a wrapper put in place of its own module's name (iou_kernels.
    # box_iou_rotated_matrix) counts its launches here meanwhile: the count
    # goes on from the wrapper's and is handed back after
    counts_here = own and hasattr(original, 'launches') and \
        original.__module__ == getattr(obj, '__name__', None)
    record.launches = getattr(original, 'launches', 0)
    setattr(obj, name, record)
    try:
        yield calls
    finally:
        if own:
            setattr(obj, name, original)
        else:
            delattr(obj, name)
        if counts_here:
            original.launches = record.launches


# ---- 1. device -----------------------------------------------------------
def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError('chip_smoke: no CUDA device is available')
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f'[device] {kind} x{torch.cuda.device_count()}, torch '
        f'{torch.__version__}, CUDA {torch.version.cuda}')
    log(smi)                 # name, power limit: as nvidia-smi gives them
    return dict(kind=kind, count=torch.cuda.device_count(), card=smi)


# ---- 2. build ------------------------------------------------------------
def phase_build():
    from orientedobjectdetection_torch.utils.cuda_build import build
    t0 = time.perf_counter()
    libs = build(list(KERNELS))
    log(f'[build] {len(libs)} kernel(s) in '
        f'{time.perf_counter() - t0:.2f} s')
    for name, lib in libs.items():
        log(f'[build] {name}: nvcc {lib.seconds:.2f} s -> {lib.path.name}')
        for line in lib.log.splitlines():
            if 'registers' in line or 'spill' in line or 'smem' in line:
                log(f'[build]   {line.strip()}')


# ---- 3. kernel vs plain --------------------------------------------------
def dota_candidates(bsz, n, seed, num_classes=15, duplicates=False):
    """Score-sorted, class-major NMS inputs like the multiclass path makes:
    centres in 0-1024, sides 4-64 px, angles in [-pi/2, pi/2), 15 classes.
    ``duplicates``: neighbours repeat boxes exactly, and the last quarter is
    zero-size padding of class ``num_classes``."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0, 1024, (bsz, n)),
                      rng.uniform(0, 1024, (bsz, n)),
                      rng.uniform(4, 64, (bsz, n)),
                      rng.uniform(4, 64, (bsz, n)),
                      rng.uniform(-np.pi / 2, np.pi / 2, (bsz, n))],
                     -1).astype(np.float32)
    cls = np.sort(rng.integers(0, num_classes, (bsz, n)), -1)
    if duplicates:
        boxes[:, 1::2] = boxes[:, 0:-1:2]
        cls[:, 1::2] = cls[:, 0:-1:2]
        pad = n // 4
        boxes[:, -pad:] = 0.0
        cls[:, -pad:] = num_classes
    return boxes, cls.astype(np.int32)


def check_pair_mask(boxes, cls) -> tuple:
    """Kernel (wrapper) vs plain version on the same device tensors.
    Returns (max |kernel - plain| outside the band, in-band mismatches)."""
    from orientedobjectdetection_torch.ops.iou_kernels import (
        nms_pair_mask, nms_pair_mask_plain, pair_iou)
    got = nms_pair_mask(boxes, IOU_THR, cls)
    ref = nms_pair_mask_plain(boxes, IOU_THR, cls)
    band = (pair_iou(boxes) - IOU_THR).abs() < BAND
    diff = (got.int() - ref.int()).abs()
    err = int(diff[~band].max()) if (~band).any() else 0
    if err:
        raise AssertionError(f'pair mask differs from the plain version '
                             f'outside the band at {int((diff[~band]).sum())}'
                             f' pairs')
    n = boxes.shape[1]
    lower = torch.ones(n, n, dtype=torch.bool, device=boxes.device).tril()
    if got[:, lower].any():
        raise AssertionError('pair mask has bits on or below the diagonal')
    return err, int(diff[band].sum())


def time_ms(fn, reps, device, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    sync(device)
    if torch.device(device).type == 'cuda':
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def pair_mask_bound_ms(boxes, cls) -> tuple:
    """Least time for these inputs: each input byte read and each output
    byte written once, and FLOP_PER_PAIR for every pair whose answer needs
    the clip math (same class, i < j, and kept by the exact reject
    ``pairs_in_reach``), at the published peaks. Returns (bound ms, what
    bounds it, same-class pairs, those of them in reach)."""
    from orientedobjectdetection_torch.ops.iou_kernels import pairs_in_reach
    n = boxes.shape[1]
    same = torch.triu(cls[:, :, None] == cls[:, None, :], diagonal=1)
    in_reach = int((same & pairs_in_reach(boxes, boxes)).sum())
    nbytes = (boxes.numel() * 4 + cls.numel() * 4 + boxes.shape[0] * n * n)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = in_reach * FLOP_PER_PAIR / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations'), int(same.sum()), \
        in_reach


def phase_kernel(device, card='', bsz=8, n=2000, small_n=300, reps=50,
                 plain_reps=3) -> dict:
    cases = {'main': dota_candidates(bsz, n, 0),
             'small': dota_candidates(bsz, small_n, 1),
             'duplicates': dota_candidates(2, small_n, 2, duplicates=True)}
    max_err = 0
    main = None
    for name, (b, c) in cases.items():
        boxes = torch.from_numpy(b).to(device)
        cls = torch.from_numpy(c).to(device)
        err, in_band = check_pair_mask(boxes, cls)
        max_err = max(max_err, err)
        log(f'[kernel] nms_pair_mask {name} B={b.shape[0]} N={b.shape[1]}: '
            f'equal to plain outside +-{BAND} of thr={IOU_THR} '
            f'({in_band} in-band differences)')
        if name == 'main':
            main = (boxes, cls)
    timing = time_pair_mask(*main, device, card, f'B={bsz} N={n}', reps,
                            plain_reps)
    return dict(name='nms_pair_mask', **KERNELS['nms_pair_mask'],
                max_abs_err=max_err, library_ms=None, **timing)


def time_pair_mask(boxes, cls, device, card, label, reps, plain_reps) -> dict:
    """Kernel (``reps`` launches) and plain version on one input, beside
    the bound and the pair counts it rests on."""
    from orientedobjectdetection_torch.ops.iou_kernels import (
        nms_pair_mask, nms_pair_mask_plain)
    ms = time_ms(lambda: nms_pair_mask(boxes, IOU_THR, cls), reps, device)
    plain_ms = time_ms(lambda: nms_pair_mask_plain(boxes, IOU_THR, cls),
                       plain_reps, device, warmup=1)
    bound_ms, bound_by, same, in_reach = pair_mask_bound_ms(boxes, cls)
    log(f'[kernel] {card} | nms_pair_mask {label}: kernel {ms:.4f} ms, '
        f'plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; '
        f'{same} same-class pairs, {in_reach} of them in reach), library '
        f'none')
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, same_class_pairs=same,
                pairs_in_reach=in_reach)


# ---- 4./5. the detector ----------------------------------------------------
def build_bundle(device, dtype, max_candidates=2000, seed=0, config=CONFIG):
    """``config``'s detector (the RetinaNet R50 config by default) with
    seeded weights, normalizing raw uint8 BGR images on the device.

    Random weights leave every score near the focal prior 0.01, below
    score_thr 0.05, so NMS would see padding only: the weights are made to
    give real boxes (:func:`seed_detections`). ``max_candidates`` is the
    config's NMS size (2000); the CPU rehearsal makes it small."""
    from orientedobjectdetection_torch.apis import init_detector
    from orientedobjectdetection_torch.utils import Config
    cfg = Config.fromfile(config)
    bundle = init_detector(cfg, device=device, dtype=dtype, seed=seed,
                           device_norm=cfg.img_norm_cfg)
    bundle.detector.bbox_head.test_cfg['max_candidates'] = max_candidates
    seed_detections(bundle.detector.bbox_head)
    return bundle


def seed_detections(head) -> None:
    """Seeded random weights made to give real boxes: the class bias zeroed
    (scores near 0.5, above score_thr); RetinaNet-family deltas scaled down
    (boxes near their anchors, where they overlap as a trained detector's
    do); FCOS sides of about two strides with a small spread, and angles
    near 0."""
    with torch.no_grad():
        if hasattr(head, 'conv_cls'):
            head.conv_cls.bias.zero_()
            head.conv_reg.weight.mul_(0.05)
            head.conv_reg.bias.fill_(2.0)
            head.conv_angle.weight.mul_(0.05)
        else:
            head.retina_cls.bias.zero_()
            head.retina_reg.weight.mul_(0.05)


def raw_images(bsz, size, seed) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (bsz, size, size, 3),
                                         dtype=np.uint8))


def nms_inputs_per_image(bundle, outputs) -> list:
    """Valid (box, class) candidates entering NMS, per image: scores above
    score_thr, capped at max_candidates."""
    head = bundle.detector.bbox_head
    cfg = head.test_cfg
    with torch.inference_mode():
        _, scores = head.candidates(outputs)
    over = (scores > float(cfg.get('score_thr', 0.05))).flatten(1).sum(1)
    cap = int(cfg.get('max_candidates', 2000))
    return [min(int(v), cap) for v in over]


def check_dets(dets, labels, valid, bsz, num_classes):
    if dets.shape[0] != bsz or dets.shape[-1] != 6:
        raise AssertionError(f'dets shape {tuple(dets.shape)}')
    if not torch.isfinite(dets).all():
        raise AssertionError('non-finite detections')
    if not valid.any(1).all():
        raise AssertionError('an image produced no detection')
    lv = labels[valid]
    if (lv < 0).any() or (lv >= num_classes).any() or \
            (labels[~valid] != -1).any():
        raise AssertionError('labels out of range')


def phase_slice(device, bsz=2, size=1024, max_candidates=2000) -> None:
    """float32: the slice run with the kernel and run again with the plain
    pair mask gives the same detections."""
    from orientedobjectdetection_torch.apis import DetectorBundle
    bundle = build_bundle(device, torch.float32, max_candidates)
    plain = DetectorBundle(bundle.cfg, bundle.detector, torch.float32,
                           device_norm=bundle.device_norm,
                           plain_pair_mask=True)
    images = raw_images(bsz, size, 10)
    dets, labels, valid = bundle(images)
    p_dets, p_labels, p_valid = plain(images)
    sync(device)
    check_dets(dets, labels, valid, bsz, bundle.num_classes)
    if not (torch.equal(valid, p_valid) and torch.equal(labels, p_labels)):
        raise AssertionError('kernel and plain pair mask give different '
                             'labels or valid flags')
    err = float((dets - p_dets).abs().max())
    if err > DETS_ATOL:
        raise AssertionError(f'dets differ by {err} > {DETS_ATOL}')
    log(f'[slice] float32 B={bsz} {size}^2: kernel and plain pair mask '
        f'agree (labels/valid exact, dets max |diff| {err:.3g}); '
        f'valid dets per image {valid.sum(1).tolist()}; NMS candidates per '
        f'image {nms_inputs_per_image(bundle, bundle.forward(images))}')


def timed_requests(bundle, images, warm, timed, device) -> tuple:
    """``warm + timed`` requests through ``bundle.forward`` and
    ``bundle.decode``, each synchronized, with the launch counts set to 0
    before and read after. Returns (seconds in forward and in decode over
    the timed requests, the last outputs and detections, the counts)."""
    if torch.device(device).type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fwd = dec = 0.0
    for i in range(warm + timed):
        t0 = time.perf_counter()
        outputs = bundle.forward(images)
        sync(device)
        t1 = time.perf_counter()
        results = bundle.decode(outputs)
        sync(device)
        if i >= warm:
            fwd += t1 - t0
            dec += time.perf_counter() - t1
    return fwd, dec, outputs, results, read_launches()


def phase_serving(device, card='', bsz=8, size=1024, warm=3, timed=10,
                  dtype=torch.bfloat16, max_candidates=2000) -> tuple:
    """Requests of ``bsz`` raw images through the bundle. Returns the
    kernels' launch counts of this run, and the pair-mask kernel's inputs
    (boxes, class ids), recorded in one more request after the counts are
    read, under ``'retinanet'``."""
    bundle = build_bundle(device, dtype, max_candidates)
    images = raw_images(bsz, size, 20)
    if torch.device(device).type == 'cuda':
        images = images.pin_memory()
    fwd, dec, outputs, (dets, labels, valid), counts = timed_requests(
        bundle, images, warm, timed, device)
    launches = counts['nms_pair_mask']
    expected = warm + timed if torch.device(device).type == 'cuda' else 0
    if launches != expected:
        raise AssertionError(f'nms_pair_mask launched {launches} times for '
                             f'{warm + timed} requests (expected {expected})')
    check_dets(dets, labels, valid, bsz, bundle.num_classes)
    mem = (torch.cuda.max_memory_allocated() / 2**30
           if torch.device(device).type == 'cuda' else float('nan'))
    log(f'[serving] {card} | {str(dtype).split(".")[-1]} B={bsz} {size}^2, '
        f'{timed} timed requests after {warm} warm: '
        f'{bsz * timed / (fwd + dec):.2f} imgs/s; per request forward '
        f'{1e3 * fwd / timed:.2f} ms, decode+NMS '
        f'{1e3 * dec / timed:.2f} ms; peak memory {mem:.2f} GiB; '
        f'nms_pair_mask launches {launches} for {warm + timed} requests')
    log(f'[serving] NMS candidates per image '
        f'{nms_inputs_per_image(bundle, outputs)}; valid dets per image '
        f'{valid.sum(1).tolist()}')
    from orientedobjectdetection_torch.ops import nms
    with recording(nms, 'nms_pair_mask') as calls:
        bundle(images)
    boxes, _, cls = calls[0][0]
    profile_request(bundle, images, device)
    return counts, {'retinanet': (boxes, cls)}


def profile_request(bundle, images, device):
    """One more request under torch.profiler."""
    from torch.profiler import record_function

    def request():
        with record_function('request.forward'):
            outputs = bundle.forward(images)
        with record_function('request.decode_nms'):
            bundle.decode(outputs)

    prof = profile_run(request, device, 'request', 'request.')
    if prof['busy_us']:
        b1_us = sum(us for name, us in prof['kernels'].items()
                    if 'pair_mask' in name)
        log(f'[profile] per request: nms_pair_mask {b1_us / 1e3:.3f} ms')


def profile_run(fn, device, label, prefix, top=12) -> dict:
    """``fn()`` once under torch.profiler: device busy share of its wall
    time, the device time of the kernels launched inside each
    ``record_function`` range named ``prefix*`` (a string or a tuple of
    them; on the calling thread), each range's extent on the device's
    timeline where the profiler records it (first to last kernel, the
    port's own kernels included), and the kernels that take the most device
    time. Returns device microseconds by kernel name, by range, by host
    operator (``ops``: what the kernels launched inside it took, autograd's
    backward nodes included) and in total, and the profile itself
    (``prof``)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # the record_function ranges also appear as device-side spans: not
    # kernels
    kernels = [e for e in averages if e.device_type == cuda
               and not e.key.startswith(prefix)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    result = dict(busy_us=busy_us, wall_us=wall_us, spans={},
                  kernels={e.key: e.self_device_time_total for e in kernels},
                  ops={e.key: e.device_time_total for e in averages
                       if e.device_type != cuda}, prof=prof)
    if busy_us == 0:
        log(f'[profile] {label} {wall_us / 1e3:.2f} ms; device time not '
            f'measured by the profiler')
        return result
    log(f'[profile] {label} {wall_us / 1e3:.2f} ms wall (profiler on), '
        f'device busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}'
        f'%), {sum(e.count for e in kernels)} kernel launches')
    extent = {e.key: e.device_time_total for e in averages
              if e.key.startswith(prefix) and e.device_type == cuda}
    for e in averages:
        if e.key.startswith(prefix) and e.device_type != cuda:
            result['spans'][e.key] = e.device_time_total
            # a range whose kernels another thread launches (autograd's
            # backward) has no extent of its own
            on_device = f'{extent[e.key] / 1e3:.2f} ms' \
                if extent.get(e.key) else 'not measured'
            log(f'[profile]   {e.key} x{e.count}: host '
                f'{e.cpu_time_total / 1e3:.2f} ms, device '
                f'{e.device_time_total / 1e3:.2f} ms in its PyTorch kernels, '
                f'{on_device} from its first kernel to its last')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f'[profile]   {e.self_device_time_total / 1e3:8.3f} ms '
            f'{e.count:5d}x  {e.key[:90]}')
    return result


# ---- 6. IoU matrix kernel vs plain ------------------------------------------
def config_anchors(size, device) -> torch.Tensor:
    """The config's anchors for a ``size`` x ``size`` image, (N, 5), level
    by level in grid order, as the head's loss sees them."""
    from orientedobjectdetection_torch.utils import Config
    from orientedobjectdetection_torch.utils.registry import PRIOR_GENERATORS
    from orientedobjectdetection_torch import core  # noqa: F401 (registers)
    cfg = Config.fromfile(CONFIG).model['bbox_head']['anchor_generator']
    gen = PRIOR_GENERATORS.build(dict(cfg))
    sizes = [(-(-size // s[1]), -(-size // s[0])) for s in gen.strides]
    return torch.cat(gen.grid_priors(sizes, device=device), 0)


def seeded_gts(anchors, bsz, g, valid, seed, duplicates=False):
    """Padded gt sets (B, G, 5), labels and mask: ``valid`` boxes per image,
    each a perturbed copy of an anchor at most a quarter of the image (or
    64 px) wide, so each has anchors above the positive threshold, zero
    boxes after.
    ``duplicates``: every second valid box repeats the one before it."""
    rng = np.random.default_rng(seed)
    pool = anchors.cpu().numpy()
    extent = float(pool[:, :2].max())
    pool = pool[pool[:, 2:4].max(1) <= max(extent / 4, 64.0)]
    gts = np.zeros((bsz, g, 5), np.float32)
    for b in range(bsz):
        box = pool[rng.choice(len(pool), valid)].copy()
        box[:, :2] += rng.uniform(-3, 3, (valid, 2))
        box[:, 2:4] *= rng.uniform(0.8, 1.25, (valid, 2))
        box[:, 4] = rng.uniform(-0.3, 0.3, valid)
        if duplicates:
            pairs = valid // 2
            box[1:2 * pairs:2] = box[0:2 * pairs:2]
        gts[b, :valid] = box
    labels = rng.integers(0, 15, (bsz, g)).astype(np.int64)
    mask = np.arange(g)[None, :].repeat(bsz, 0) < valid
    return (torch.from_numpy(gts), torch.from_numpy(labels),
            torch.from_numpy(mask))


def check_iou_matrix(boxes1, boxes2, mode) -> tuple:
    """Kernel (wrapper) vs plain version on the same device tensors.
    Returns (max |kernel - plain|, pairs in reach): every pair that
    ``pairs_in_reach`` rejects must be exactly 0."""
    from orientedobjectdetection_torch.ops.iou_kernels import (
        box_iou_rotated_matrix, box_iou_rotated_matrix_plain, pairs_in_reach)
    got = box_iou_rotated_matrix(boxes1, boxes2, mode)
    ref = box_iou_rotated_matrix_plain(boxes1, boxes2, mode)
    if got.shape != ref.shape:
        raise AssertionError(f'shape {tuple(got.shape)} vs plain '
                             f'{tuple(ref.shape)}')
    if not torch.isfinite(got).all():
        raise AssertionError('non-finite IoU')
    err = float((got - ref).abs().max())
    if err > IOU_ATOL:
        raise AssertionError(f'IoU matrix differs from the plain version by '
                             f'{err} > {IOU_ATOL}')
    live = pairs_in_reach(boxes1, boxes2)
    if live.dim() < got.dim():
        live = live.expand_as(got)
    if (got[~live] != 0).any() or (ref[~live] != 0).any():
        raise AssertionError('an out-of-reach pair is not exactly 0')
    return err, int(live.sum())


def iou_matrix_bound_ms(boxes1, boxes2, live) -> tuple:
    """Least time for these inputs: each input byte read and each output
    byte written once, and FLOP_PER_IOU_PAIR for every pair within reach,
    at the published peaks."""
    batch = max(b.shape[0] if b.dim() == 3 else 1 for b in (boxes1, boxes2))
    out_bytes = batch * boxes1.shape[-2] * boxes2.shape[-2] * 4
    nbytes = boxes1.numel() * 4 + boxes2.numel() * 4 + out_bytes
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = live * FLOP_PER_IOU_PAIR / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def iou_matrix_cases(anchors, device, bsz=8, g=32, valid=8, dense_g=128,
                     big_g=512, big_valid=64) -> dict:
    """Phase 6's inputs, label -> (boxes1, boxes2, mode): ``bsz`` padded gt
    sets of ``g`` rows with ``valid`` boxes each against the anchors, both
    ways round (IoU, and the IoF of the anchors over ignore regions); dense
    and duplicated gts; one unbatched set; and the loader's padding,
    ``big_g`` rows with ``big_valid`` boxes (the JAX loader's ``max_gt``
    is 512)."""
    gts = seeded_gts(anchors, bsz, g, valid, 30)[0].to(device)
    dense = seeded_gts(anchors, 2, dense_g, dense_g, 31)[0].to(device)
    dup = seeded_gts(anchors, 2, g, valid, 32, duplicates=True)[0].to(device)
    big = seeded_gts(anchors, bsz, big_g, big_valid, 33)[0].to(device)
    return {
        'assignment': (gts, anchors, 'iou'),            # (B, G, N)
        'ignore-iof': (anchors, gts, 'iof'),            # (B, N, K)
        'dense': (dense, anchors, 'iou'),
        'duplicates': (dup, anchors, 'iou'),
        'one-image': (dup[0].contiguous(), anchors, 'iof'),
        f'padded-{big_g}': (big, anchors, 'iou'),
    }


def phase_iou_kernel(device, card='', bsz=8, g=32, valid=8, size=1024,
                     dense_g=128, big_g=512, big_valid=64, reps=50,
                     big_reps=10, plain_reps=3) -> dict:
    """The kernel against its plain version on every case of
    :func:`iou_matrix_cases`, then timed beside its bound at the assignment
    shape (with the plain version) and at the loader's padding (without:
    one plain call there takes seconds)."""
    anchors = config_anchors(size, device)
    n = anchors.shape[0]
    cases = iou_matrix_cases(anchors, device, bsz, g, valid, dense_g, big_g,
                             big_valid)
    max_err = 0.0
    live = {}
    for name, (b1, b2, mode) in cases.items():
        err, live[name] = check_iou_matrix(b1, b2, mode)
        max_err = max(max_err, err)
        total = max(b.shape[0] if b.dim() == 3 else 1 for b in (b1, b2)) * \
            b1.shape[-2] * b2.shape[-2]
        log(f'[kernel] box_iou_rotated {name} {tuple(b1.shape)} x '
            f'{tuple(b2.shape)} {mode}: max |kernel - plain| {err:.3g} <= '
            f'{IOU_ATOL}; {live[name]} of {total} pairs within reach, the '
            f'rest exactly 0')
    gts = cases['assignment'][0]
    timing = time_iou_matrix(gts, anchors, live['assignment'], device, card,
                             f'B={bsz} G={g} ({valid} valid) N={n}', reps,
                             plain_reps)
    big = cases[f'padded-{big_g}'][0]
    big_timing = time_iou_matrix(big, anchors, live[f'padded-{big_g}'],
                                 device, card, f'B={bsz} G={big_g} '
                                 f'({big_valid} valid) N={n}', big_reps, 0)
    return dict(name='box_iou_rotated', **KERNELS['box_iou_rotated'],
                max_abs_err=max_err, library_ms=None, **timing,
                padded_gts={k: big_timing[k] for k in
                            ('ms', 'bound_ms', 'bound_by', 'pairs_in_reach')})


def time_iou_matrix(boxes1, boxes2, live, device, card, label, reps,
                    plain_reps, mode='iou') -> dict:
    """Kernel (``reps`` launches) and, unless ``plain_reps`` is 0, plain
    version on one input, beside the bound for ``live`` pairs in reach."""
    from orientedobjectdetection_torch.ops.iou_kernels import (
        box_iou_rotated_matrix, box_iou_rotated_matrix_plain)
    ms = time_ms(lambda: box_iou_rotated_matrix(boxes1, boxes2, mode), reps,
                 device)
    plain_ms = time_ms(
        lambda: box_iou_rotated_matrix_plain(boxes1, boxes2, mode),
        plain_reps, device, warmup=1) if plain_reps else None
    bound_ms, bound_by = iou_matrix_bound_ms(boxes1, boxes2, live)
    plain = f'{plain_ms:.3f} ms' if plain_reps else 'not timed'
    log(f'[kernel] {card} | box_iou_rotated {label}: kernel {ms:.4f} ms, '
        f'plain {plain}, bound {bound_ms:.4f} ms ({bound_by}; {live} pairs '
        f'within reach), library none')
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, pairs_in_reach=live)


# ---- 7./8. the trainer ------------------------------------------------------
def build_trainer(device, dtype, seed=0, plain_iou=False, config=CONFIG,
                  norm_eval=True):
    """``config``'s detector (the RetinaNet R50 config by default) with
    seeded weights (an FCOS head's regression as in
    :func:`seed_detections`, so its boxes have sides; a point-set head's
    points spread as :func:`spread_point_sets` spreads them) and the config's
    optimizer (SGD, momentum, weight decay, clip, linear warmup, frozen stem
    and stage 1), normalizing raw uint8 BGR images on the device. Returns
    (detector, state, train_step). ``plain_iou``: the assigner, where the
    head has one, computes its IoU matrix with the plain version (a
    reference run; a refine detector's in every stage). ``norm_eval=False``:
    the step trains with live BatchNorm."""
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.parallel import (
        build_lr_schedule, build_optimizer, create_train_state,
        make_train_step)
    from orientedobjectdetection_torch.utils import Config
    cfg = Config.fromfile(config)
    detector = build_detector(dict(cfg.model))
    for assigner in assigners(detector):
        assigner.plain_iou = plain_iou
    head = getattr(detector, 'bbox_head', None)
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 steps_per_epoch=1000)
    tx = build_optimizer(dict(cfg.optimizer), schedule,
                         grad_clip=cfg.optimizer_config['grad_clip'],
                         frozen_stages=detector.backbone.frozen_stages)
    state = create_train_state(detector, tx, device=device, seed=seed)
    if hasattr(head, 'conv_reg'):
        with torch.no_grad():
            head.conv_reg.weight.mul_(0.05)
            head.conv_reg.bias.fill_(2.0)
    if hasattr(head, 'reppoints_pts_init_out'):
        spread_point_sets(head)
    step = make_train_step(detector, tx, device_norm=cfg.img_norm_cfg,
                           dtype=dtype, norm_eval=norm_eval)
    return detector, state, step


def assigners(detector) -> list:
    """The assigners of a single-stage detector's head, of each stage of a
    refine detector, or of a two-stage detector's RPN and RoI stages."""
    if hasattr(detector, 'assigners'):
        return detector.assigners()
    heads = detector.heads() if hasattr(detector, 'heads') else \
        [detector.bbox_head]
    return [h.assigner for h in heads
            if getattr(h, 'assigner', None) is not None]


def train_batch(bsz, size, g, valid, seed, device) -> dict:
    """Raw uint8 images and seeded padded gts, on the host (pinned when the
    run is on a card)."""
    gts, labels, mask = seeded_gts(config_anchors(size, 'cpu'), bsz, g,
                                   valid, seed)
    batch = dict(images=raw_images(bsz, size, seed + 1), gt_bboxes=gts,
                 gt_labels=labels, gt_mask=mask)
    if torch.device(device).type == 'cuda':
        batch = {k: v.pin_memory() for k, v in batch.items()}
    return batch


def check_assigner(assigner, priors, gts, labels, mask) -> tuple:
    """The assigner on these inputs with the kernel and with the plain
    matrix: equal except where a prior's max IoU lies within ASSIGN_BAND of
    one of the assigner's thresholds or, with low-quality matches, its IoU
    with some gt within ASSIGN_BAND of that gt's best (rounding can move
    either). Returns (positives, differing priors, all of them inside the
    band)."""
    from orientedobjectdetection_torch.ops.iou_kernels import (
        box_iou_rotated_matrix_plain)
    was = assigner.plain_iou
    try:
        assigner.plain_iou = False
        got = assigner(priors, gts, labels, mask)
        assigner.plain_iou = True
        ref = assigner(priors, gts, labels, mask)
    finally:
        assigner.plain_iou = was
    differ = got.assigned_gt_inds != ref.assigned_gt_inds
    band = torch.zeros_like(differ)
    if assigner.match_low_quality:
        overlaps = box_iou_rotated_matrix_plain(gts, priors)
        overlaps = overlaps * mask[:, :, None]
        band |= ((overlaps - overlaps.amax(2, keepdim=True)).abs()
                 < ASSIGN_BAND).any(1)
    thresholds = [assigner.neg_iou_thr, assigner.pos_iou_thr]
    if assigner.match_low_quality and assigner.min_pos_iou > 0:
        thresholds.append(assigner.min_pos_iou)
    for thr in thresholds:
        band |= (ref.max_overlaps - thr).abs() < ASSIGN_BAND
    outside = int((differ & ~band).sum())
    if outside:
        raise AssertionError(f'{outside} assignments differ between kernel '
                             f'and plain outside the band')
    if float((got.max_overlaps - ref.max_overlaps).abs().max()) > IOU_ATOL:
        raise AssertionError('max_overlaps differ between kernel and plain')
    return int((got.assigned_gt_inds >= 0).sum()), int(differ.sum())


def check_assignments(detector, batch, size, device) -> tuple:
    """:func:`check_assigner` for the RetinaNet head's assigner on the
    batch's gts and the config's anchors."""
    gts, labels, mask = (batch[k].to(device) for k in
                         ('gt_bboxes', 'gt_labels', 'gt_mask'))
    return check_assigner(detector.bbox_head.assigner,
                          config_anchors(size, device), gts, labels, mask)


def check_metrics(metrics):
    """Every loss, the total and the gradient norm are finite."""
    for k, v in metrics.items():
        if not torch.isfinite(v):
            raise AssertionError(f'{k} is not finite: {v}')


def one_train_step(device, batch, plain_iou) -> tuple:
    """A fresh seeded float32 trainer takes one step on ``batch``. Checks
    that exactly the trainable tensors moved; returns the metrics as floats
    and the numbers of frozen and trainable tensors."""
    detector, state, step = build_trainer(device, torch.float32,
                                          plain_iou=plain_iou)
    before = {n: p.detach().clone() for n, p in detector.named_parameters()}
    state, metrics = step(state, batch)
    sync(device)
    check_metrics(metrics)
    for n, p in detector.named_parameters():
        moved = not torch.equal(p, before[n])
        if moved != p.requires_grad:
            raise AssertionError(f'{n}: frozen tensor changed' if moved
                                 else f'{n}: trainable tensor did not change')
    frozen = sum(not p.requires_grad for p in detector.parameters())
    return ({k: float(v) for k, v in metrics.items()}, frozen,
            len(before) - frozen)


def phase_train_slice(device, bsz=2, size=1024, g=32, valid=8) -> None:
    """float32: one train step with the kernel and one from the same seeded
    state with the plain IoU matrix give the same assignments and losses;
    frozen tensors stay, trainable ones move."""
    batch = train_batch(bsz, size, g, valid, 40, device)
    detector = build_trainer(device, torch.float32)[0]
    positives, differ = check_assignments(detector, batch, size, device)
    del detector
    if positives < 1:
        raise AssertionError('the batch has no positive anchor')
    kernel, frozen, trainable = one_train_step(device, batch, False)
    plain = one_train_step(device, batch, True)[0]
    for k in ('loss_cls', 'loss_bbox'):
        if abs(kernel[k] - plain[k]) > LOSS_RTOL * abs(plain[k]):
            raise AssertionError(f'{k}: kernel {kernel[k]} vs plain '
                                 f'{plain[k]}')
    log(f'[train-slice] float32 B={bsz} {size}^2, G={g} ({valid} valid): '
        f'{positives} positive anchors; assignments with kernel and plain '
        f'matrix differ at {differ} priors, all within {ASSIGN_BAND} of a '
        f'threshold or of a gt\'s best IoU; kernel {kernel} vs plain '
        f'{plain} (rtol {LOSS_RTOL}); {frozen} frozen tensors unchanged, '
        f'{trainable} trainable tensors changed')


def phase_training(device, card='', bsz=8, size=1024, g=32, valid=8, warm=3,
                   timed=10, dtype=torch.bfloat16) -> tuple:
    """``warm + timed`` train steps on one fixed batch. Returns the
    kernels' launch counts of this run, and the IoU-matrix kernel's inputs
    (boxes1, boxes2, mode), recorded in one more step after the counts are
    read, under ``'train_step'``."""
    on_card = torch.device(device).type == 'cuda'
    detector, state, step = build_trainer(device, dtype)
    batch = train_batch(bsz, size, g, valid, 50, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    history = []
    for _ in range(warm):
        state, metrics = step(state, batch)
        history.append(metrics)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(timed):
        state, metrics = step(state, batch)
        history.append(metrics)
    sync(device)
    seconds = time.perf_counter() - t0
    counts = read_launches()
    launches = counts['box_iou_rotated']
    expected = warm + timed if on_card else 0   # one IoU matrix per step
    if launches != expected:
        raise AssertionError(f'box_iou_rotated launched {launches} times in '
                             f'{warm + timed} steps (expected {expected})')
    for metrics in history:
        check_metrics(metrics)
    losses = [float(m['loss']) for m in history]
    if not losses[-1] < losses[0]:
        raise AssertionError(f'the loss did not fall on the fixed batch: '
                             f'{losses}')
    if state.step != warm + timed:
        raise AssertionError(f'state.step {state.step}')
    mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
        else float('nan')
    log(f'[training] {card} | {str(dtype).split(".")[-1]} B={bsz} {size}^2, '
        f'G={g} ({valid} valid), {timed} timed steps after {warm} warm: '
        f'{bsz * timed / seconds:.2f} imgs/s, {1e3 * seconds / timed:.2f} '
        f'ms per step; peak memory {mem:.2f} GiB; box_iou_rotated launches '
        f'{launches} in {warm + timed} steps '
        f'({launches / (warm + timed):g} per step)')
    log(f'[training] loss {losses[0]:.4f} -> {losses[-1]:.4f} (loss_cls '
        f'{float(history[0]["loss_cls"]):.4f} -> '
        f'{float(history[-1]["loss_cls"]):.4f}, loss_bbox '
        f'{float(history[0]["loss_bbox"]):.4f} -> '
        f'{float(history[-1]["loss_bbox"]):.4f}); grad_norm '
        f'{float(history[0]["grad_norm"]):.3f} -> '
        f'{float(history[-1]["grad_norm"]):.3f}')
    from orientedobjectdetection_torch.ops import iou_kernels
    with recording(iou_kernels, 'box_iou_rotated_matrix') as calls:
        state, _ = step(state, batch)
    prof = profile_run(lambda: step(state, batch), device, 'train step',
                       'train.')
    if prof['busy_us']:
        spans = prof['spans']
        named = sum(spans.get(k, 0) for k in
                    ('train.forward', 'train.loss', 'train.update'))
        b2_us = sum(us for name, us in prof['kernels'].items()
                    if 'iou_matrix_kernel' in name)
        # backward's kernels are launched by the autograd thread, outside
        # the ranges of the calling thread: they are the remainder
        log(f'[profile] device time: forward '
            f'{spans.get("train.forward", 0) / 1e3:.2f} ms, targets + loss '
            f'{spans.get("train.loss", 0) / 1e3:.2f} ms (box_iou_rotated '
            f'{b2_us / 1e3:.3f} ms of it), optimizer '
            f'{spans.get("train.update", 0) / 1e3:.2f} ms, backward (the '
            f'rest) {(prof["busy_us"] - named) / 1e3:.2f} ms')
    return counts, {'train_step': calls[0][0],
                    'training_imgs_per_s': bsz * timed / seconds}


# ---- 9. RoIAlign kernel vs plain --------------------------------------------
def seeded_rois(bsz, r, size, seed) -> np.ndarray:
    """(B, R, 5) float32 RoIs for a ``size`` x ``size`` image: centres
    anywhere in it, sqrt(w * h) log-uniform from 20 px up (levels 0 to 2 or
    3 of the router), aspect up to e, angles in [-pi/2, pi/2). Then, an
    eighth of R each: elongated RoIs (aspect 6.5 to 10, long side 0.15 to
    0.3 of the image: more level-0 cells than the TPU kernel's window held);
    one giant RoI clamped to the top level; RoIs centred outside the image;
    and, last, zero-size padding."""
    rng = np.random.default_rng(seed)
    side = np.exp(rng.uniform(np.log(20.0), np.log(min(1.2 * size, 700.0)),
                              (bsz, r)))
    aspect = np.exp(rng.uniform(-1.0, 1.0, (bsz, r)))
    rois = np.stack([rng.uniform(0, size, (bsz, r)),
                     rng.uniform(0, size, (bsz, r)),
                     side * np.sqrt(aspect), side / np.sqrt(aspect),
                     rng.uniform(-np.pi / 2, np.pi / 2, (bsz, r))], -1)
    n = max(r // 8, 1)
    long_side = rng.uniform(0.15, 0.3, (bsz, n)) * size
    rois[:, :n, 2] = long_side
    rois[:, :n, 3] = long_side / rng.uniform(6.5, 10.0, (bsz, n))
    rois[:, n] = [size / 2, size / 2, max(1.4 * size, 520.0),
                  max(1.3 * size, 480.0), 0.7]
    rois[:, n + 1:2 * n + 1, 0] = rng.choice([-0.03, 1.03], (bsz, n)) * size
    rois[:, -n:] = 0.0
    return rois.astype(np.float32)


def seeded_pyramid(bsz, size, channels, dtype, device, seed) -> list:
    """Channels-last normal features for strides 4, 8, 16, 32 of a ``size``
    x ``size`` image, from a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((bsz, -(-size // s), -(-size // s), channels),
                        generator=gen, device=device).to(dtype)
            for s in (4, 8, 16, 32)]


def check_roi_align(feats, rois, clockwise, padding=True,
                    ratio=2) -> float:
    """Kernel (wrapper) vs plain version on the same device tensors, held
    per element to ``ROI_RTOL`` and ``ROI_BF16_STEP``. Returns
    max |kernel - plain|; padding RoIs must give exact zeros, and with
    ``padding`` the input must have some. ``ratio``: samples a bin side."""
    from orientedobjectdetection_torch.ops.roi_align_kernels import (
        roi_align_rotated_pyramid, roi_align_rotated_pyramid_plain)
    args = (feats, rois, (7, 7), ROI_SCALES, ratio, 56.0, clockwise)
    got = roi_align_rotated_pyramid(*args)
    ref = roi_align_rotated_pyramid_plain(*args)
    if got.shape != ref.shape or got.dtype != feats[0].dtype or \
            got.shape != rois.shape[:2] + (7, 7, feats[0].shape[-1]):
        raise AssertionError(f'pooled {tuple(got.shape)} {got.dtype} vs '
                             f'plain {tuple(ref.shape)} {ref.dtype}')
    if not torch.isfinite(got).all():
        raise AssertionError('non-finite pooled feature')
    pad = (rois[..., 2] <= 1e-3) | (rois[..., 3] <= 1e-3)
    if (padding and not pad.any()) or int(torch.count_nonzero(got[pad])):
        raise AssertionError('padding RoIs are missing or not exactly 0')
    scale = max(float(f.abs().max()) for f in feats)
    step = ROI_BF16_STEP if got.dtype == torch.bfloat16 else 0.0
    diff = (got.float() - ref.float()).abs()
    over = diff - (ROI_RTOL * scale + step * ref.float().abs())
    if float(over.max()) > 0:
        raise AssertionError(
            f'pooled features differ from the plain version by '
            f'{float(over.max())} more than {ROI_RTOL} x {scale} + {step} x '
            f'|plain| allows')
    return float(diff.max())


def roi_align_work(feats, rois, clockwise=False, ratio=2) -> tuple:
    """What these inputs need: (feature cells some sample's bilinear corner
    reads, counted once each; RoIs that are not padding; RoIs per level).
    ``ratio``: samples a bin side."""
    from orientedobjectdetection_torch.ops.roi_align_rotated import (
        level_of_rois)
    dev = rois.device
    lvl = level_of_rois(rois, len(feats), 56.0)
    live = (rois[..., 2] > 1e-3) & (rois[..., 3] > 1e-3)
    side = 7 * ratio
    g = (torch.arange(side, dtype=torch.float32, device=dev) + 0.5) / side \
        - 0.5
    gyy, gxx = (t.reshape(-1) for t in torch.meshgrid(g, g, indexing='ij'))
    cx, cy, w, h, a = (rois[..., i, None] for i in range(5))
    a = -a if clockwise else a
    px = cx + gxx * w * torch.cos(a) - gyy * h * torch.sin(a)
    py = cy + gxx * w * torch.sin(a) + gyy * h * torch.cos(a)
    scale = torch.tensor(ROI_SCALES, device=dev)[lvl][..., None]
    x0 = torch.floor(px * scale - 0.5).long()
    y0 = torch.floor(py * scale - 0.5).long()
    image = torch.arange(rois.shape[0], device=dev)[:, None, None]
    cells = 0
    for level, f in enumerate(feats):
        fh, fw = f.shape[1:3]
        hit = torch.zeros((rois.shape[0], fh * fw), dtype=torch.bool,
                          device=dev)
        here = ((lvl == level) & live)[..., None]
        for dx in (0, 1):
            for dy in (0, 1):
                x, y = x0 + dx, y0 + dy
                ok = here & (x >= 0) & (x < fw) & (y >= 0) & (y < fh)
                hit[image.expand_as(ok)[ok], (y * fw + x)[ok]] = True
        cells += int(hit.sum())
    per_level = torch.bincount(lvl[live], minlength=len(feats)).tolist()
    return cells, int(live.sum()), per_level


def roi_align_bound_ms(feats, rois, cells, live, ratio=2) -> tuple:
    """Least time for these inputs: the RoIs and every feature cell that is
    touched read once, the output written once, and 49 x ratio^2 samples
    (196 at ratio 2) x 4 corner FMAs per channel of every RoI that is not
    padding, at the published peaks."""
    c = feats[0].shape[-1]
    elt = feats[0].element_size()
    out_elems = rois.shape[0] * rois.shape[1] * 49 * c
    nbytes = rois.numel() * 4 + (cells * c + out_elems) * elt
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = live * 49 * ratio ** 2 * 4 * 2 * c / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def phase_roi_kernel(device, card='', bsz=8, r=2000, size=1024, channels=256,
                     odd=(3, 37, 200, 64), reps=20, plain_reps=2) -> dict:
    """``odd``: (B, R, image size, C) of the small odd-shaped case."""
    rois = torch.from_numpy(seeded_rois(bsz, r, size, 70)).to(device)
    feats32 = seeded_pyramid(bsz, size, channels, torch.float32, device, 71)
    feats16 = [f.to(torch.bfloat16) for f in feats32]
    odd_rois = torch.from_numpy(seeded_rois(odd[0], odd[1], odd[2],
                                            72)).to(device)
    odd_feats = seeded_pyramid(odd[0], odd[2], odd[3], torch.float32, device,
                               73)
    cases = {'float32': (feats32, rois),
             'bfloat16': (feats16, rois),
             'odd-float32': (odd_feats, odd_rois),
             'odd-bfloat16': ([f.to(torch.bfloat16) for f in odd_feats],
                              odd_rois)}
    max_err = 0.0
    for name, (feats, boxes) in cases.items():
        bound = f'{ROI_RTOL:.3g} x max |feature|' + (
            f' + {ROI_BF16_STEP:.3g} x |plain|' if 'bfloat16' in name else '')
        # 2 samples a bin side, and 1 (Rotated Faster R-CNN's)
        for clockwise, ratio in ((False, 2), (True, 2), (False, 1),
                                 (True, 1)):
            err = check_roi_align(feats, boxes, clockwise, ratio=ratio)
            max_err = max(max_err, err)
            log(f'[kernel] roi_align_rotated {name} B={boxes.shape[0]} '
                f'R={boxes.shape[1]} C={feats[0].shape[-1]} levels '
                f'{[f.shape[1] for f in feats]} clockwise={clockwise} '
                f'sampling_ratio={ratio}: max |kernel - plain| {err:.3g}, '
                f'each element <= {bound}; padding RoIs exactly 0')
    cells, live, per_level = roi_align_work(feats32, rois)
    if min(per_level) < 1:
        raise AssertionError(f'a pyramid level got no RoI: {per_level}')
    aspect = rois[..., 2] / rois[..., 3].clamp(min=1e-3)
    log(f'[kernel] roi_align_rotated inputs: {live} of {rois.shape[0] * r} '
        f'RoIs live, per level {per_level}, {int((aspect > 6).sum())} with '
        f'aspect > 6, {cells} feature cells touched')
    timed = {name: time_roi_align(
        feats, rois, (cells, live), device, card,
        f'{name} B={bsz} R={r} C={channels}', reps, plain_reps)
        for name, feats in (('float32', feats32), ('bfloat16', feats16))}
    # serving runs bfloat16: those are the record's numbers
    return dict(name='roi_align_rotated', **KERNELS['roi_align_rotated'],
                max_abs_err=max_err, library_ms=None, **timed['bfloat16'],
                ms_float32=timed['float32']['ms'],
                plain_ms_float32=timed['float32']['plain_ms'],
                bound_ms_float32=timed['float32']['bound_ms'])


def time_roi_align(feats, rois, work, device, card, label, reps,
                   plain_reps, ratio=2) -> dict:
    """Kernel (``reps`` launches) and plain version on one input, beside
    the bound for ``work`` = (cells touched, live RoIs)."""
    from orientedobjectdetection_torch.ops.roi_align_kernels import (
        roi_align_rotated_pyramid, roi_align_rotated_pyramid_plain,
        vector_path)
    args = (feats, rois, (7, 7), ROI_SCALES, ratio, 56.0)
    ms = time_ms(lambda: roi_align_rotated_pyramid(*args), reps, device)
    plain_ms = time_ms(lambda: roi_align_rotated_pyramid_plain(*args),
                       plain_reps, device, warmup=1)
    bound_ms, bound_by = roi_align_bound_ms(feats, rois, *work, ratio)
    path = 'vector' if vector_path(feats) else 'scalar'
    log(f'[kernel] {card} | roi_align_rotated {label} ({path} path): kernel '
        f'{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms '
        f'({bound_by}), library none')
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# ---- 10./11. Oriented R-CNN -------------------------------------------------
def build_orcnn_bundle(device, dtype, max_num=2000, max_candidates=2000,
                       seed=0):
    """The Oriented R-CNN config's detector with seeded weights,
    normalizing raw uint8 BGR images on the device.

    The regression outputs of both stages are scaled down so proposals stay
    near their anchors and detections near their proposals, where they
    overlap as a trained detector's do; biases are zero, so objectness sits
    near 0.5 and the softmax spreads over the classes. ``max_num`` is the
    config's number of proposals per image (2000) and ``max_candidates`` its
    NMS size (2000); the CPU rehearsal makes them small."""
    from orientedobjectdetection_torch.apis import init_detector
    from orientedobjectdetection_torch.utils import Config
    cfg = Config.fromfile(ORCNN_CONFIG)
    bundle = init_detector(cfg, device=device, dtype=dtype, seed=seed,
                           device_norm=cfg.img_norm_cfg)
    det = bundle.detector
    det.test_cfg['rpn']['max_per_img'] = max_num
    det.test_cfg['rcnn']['max_candidates'] = max_candidates
    with torch.no_grad():
        det.rpn_head.rpn_reg.weight.mul_(0.05)
        det.roi_head.bbox_head.fc_reg.weight.mul_(0.05)
    return bundle


def check_orcnn_outputs(bundle, outputs, max_num, max_candidates) -> tuple:
    """Every image has ``max_num`` valid proposals on at least three pyramid
    levels and at least ``max_candidates`` (RoI, class) scores past
    score_thr. Returns (RoIs per level, candidates per image)."""
    from orientedobjectdetection_torch.ops.roi_align_rotated import (
        level_of_rois)
    valid = outputs['prop_valid']
    if not bool((valid.sum(1) == max_num).all()):
        raise AssertionError(f'valid proposals per image '
                             f'{valid.sum(1).tolist()}, expected {max_num}')
    lvl = level_of_rois(outputs['proposals'], 4, 56.0)
    per_level = [torch.bincount(img_lvl[img_valid], minlength=4).tolist()
                 for img_lvl, img_valid in zip(lvl, valid)]
    if any(sum(n > 0 for n in counts) < 3 for counts in per_level):
        raise AssertionError(f'proposals on fewer than three levels: '
                             f'{per_level}')
    thr = float(bundle.detector.test_cfg['rcnn'].get('score_thr', 0.05))
    scores = torch.softmax(outputs['cls_score'], -1)[..., :-1]
    over = (scores > thr).flatten(1).sum(1).tolist()
    if min(over) < max_candidates:
        raise AssertionError(f'(RoI, class) scores past score_thr per image '
                             f'{over}, expected >= {max_candidates}')
    return per_level, over


def same_detections(got, ref, cut_scores) -> tuple:
    """Two (dets, labels, valid) results hold the same detections, up to
    what a score moved by less than SCORE_BAND can do: rows that close in
    score may come out in another order, and a candidate that close to the
    lowest score entering NMS (``cut_scores``, per image) may be another
    one. That candidate is the last of its class in NMS and suppresses
    nothing, so only rows within the band of the cut are set aside. Returns
    (max |diff| of matched rows, rows in another place, rows set aside)."""
    max_err, moved, aside = 0.0, 0, 0
    for image, cut in enumerate(cut_scores):
        rows = []
        for dets, labels, valid in (got, ref):
            d, lab = dets[image][valid[image]], labels[image][valid[image]]
            clear = d[:, 5] >= float(cut) + SCORE_BAND
            aside += int((~clear).sum())
            rows.append((d[clear], lab[clear]))
        (d1, l1), (d2, l2) = rows
        if len(d1) != len(d2):
            raise AssertionError(f'image {image}: {len(d1)} vs {len(d2)} '
                                 f'detections clear of the cut')
        if not len(d1):
            continue
        cost = (d1[:, None, :] - d2[None, :, :]).abs().amax(-1)
        cost = cost.masked_fill(l1[:, None] != l2[None, :], float('inf'))
        err, match = cost.min(1)
        place = torch.arange(len(d1), device=match.device)
        if float(err.max()) > DETS_ATOL or \
                not torch.equal(match.sort()[0], place):
            raise AssertionError(f'image {image}: detections differ (max '
                                 f'|diff| of the nearest rows '
                                 f'{float(err.max())})')
        gap = (d1[:, 5] - d1[match, 5]).abs()
        if float(gap.max()) >= SCORE_BAND:
            raise AssertionError(f'image {image}: rows {float(gap.max())} '
                                 f'apart in score changed places')
        max_err = max(max_err, float(err.max()))
        moved += int((match != place).sum())
    return max_err, moved, aside


def phase_orcnn_slice(device, bsz=2, size=1024, max_num=2000,
                      max_candidates=2000) -> None:
    """float32: the Oriented R-CNN slice with the RoIAlign kernel and with
    its plain version gives the same head outputs within HEAD_ATOL and the
    same detections up to near-ties in score; the same head outputs decoded
    with the pair-mask kernel and with its plain version give equal
    detections."""
    from orientedobjectdetection_torch.apis import DetectorBundle
    bundle = build_orcnn_bundle(device, torch.float32, max_num,
                                max_candidates)
    plain_roi, plain_mask = (
        DetectorBundle(bundle.cfg, bundle.detector, torch.float32,
                       device_norm=bundle.device_norm, **{switch: True})
        for switch in ('plain_roi_align', 'plain_pair_mask'))
    images = raw_images(bsz, size, 60)
    outputs = bundle.forward(images)
    per_level, over = check_orcnn_outputs(bundle, outputs, max_num,
                                          max_candidates)
    dets, labels, valid = bundle.decode(outputs)
    sync(device)
    check_dets(dets, labels, valid, bsz, bundle.num_classes)

    m_dets, m_labels, m_valid = plain_mask.decode(outputs)
    if not (torch.equal(valid, m_valid) and torch.equal(labels, m_labels)):
        raise AssertionError('kernel and plain pair mask give different '
                             'labels or valid flags')
    mask_err = float((dets - m_dets).abs().max())
    if mask_err > DETS_ATOL:
        raise AssertionError(f'dets differ by {mask_err} > {DETS_ATOL}')

    p_outputs = plain_roi.forward(images)
    if not torch.equal(outputs['proposals'], p_outputs['proposals']):
        raise AssertionError('the proposals changed with plain_roi_align')
    head_err = max(float((outputs[k] - p_outputs[k]).abs().max())
                   for k in ('cls_score', 'bbox_pred'))
    if head_err > HEAD_ATOL:
        raise AssertionError(f'head outputs with the kernel and the plain '
                             f'RoIAlign differ by {head_err} > {HEAD_ATOL}')
    scores = torch.softmax(outputs['cls_score'], -1)[..., :-1].flatten(1)
    cut = scores.topk(min(max_candidates, scores.shape[1]))[0][:, -1]
    roi_err, moved, aside = same_detections(
        (dets, labels, valid), plain_roi.decode(p_outputs), cut)
    sync(device)
    log(f'[orcnn-slice] float32 B={bsz} {size}^2: pair-mask kernel and plain '
        f'mask on the same head outputs agree (labels/valid exact, dets max '
        f'|diff| {mask_err:.3g}); RoIAlign kernel and plain version: head '
        f'outputs max |diff| {head_err:.3g} <= {HEAD_ATOL}, the same '
        f'detections (max |diff| {roi_err:.3g}; {moved} rows within '
        f'{SCORE_BAND} in score in another place, {aside} within that of the '
        f'NMS cut set aside)')
    log(f'[orcnn-slice] RoIs per level {per_level}; (RoI, class) scores past '
        f'score_thr {over}; valid dets per image {valid.sum(1).tolist()}')


def phase_orcnn_serving(device, card='', bsz=8, size=1024, warm=3, timed=10,
                        split=3, dtype=torch.bfloat16, max_num=2000,
                        max_candidates=2000) -> tuple:
    """Requests of ``bsz`` raw images through the Oriented R-CNN bundle.
    Returns the kernels' launch counts of the ``warm + timed`` requests,
    and the inputs of the pair-mask kernel (boxes, class ids) under
    ``'orcnn'`` and of the RoIAlign kernel (levels, RoIs) under
    ``'orcnn_roi'``, recorded in one more request after the counts are
    read. Then ``split`` more requests run under the profiler, which splits
    them by the detector's ``two_stage.*`` ranges."""
    on_card = torch.device(device).type == 'cuda'
    bundle = build_orcnn_bundle(device, dtype, max_num, max_candidates)
    images = raw_images(bsz, size, 80)
    if on_card:
        images = images.pin_memory()
    fwd, dec, outputs, (dets, labels, valid), counts = timed_requests(
        bundle, images, warm, timed, device)
    expected = warm + timed if on_card else 0
    for name in ('roi_align_rotated', 'nms_pair_mask'):
        if counts[name] != expected:
            raise AssertionError(
                f'{name} launched {counts[name]} times for {warm + timed} '
                f'requests (expected {expected})')
    check_dets(dets, labels, valid, bsz, bundle.num_classes)
    per_level, over = check_orcnn_outputs(bundle, outputs, max_num,
                                          max_candidates)
    mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
        else float('nan')
    log(f'[orcnn-serving] {card} | {str(dtype).split(".")[-1]} B={bsz} '
        f'{size}^2, {timed} timed requests after {warm} warm: '
        f'{bsz * timed / (fwd + dec):.2f} imgs/s; per request forward '
        f'{1e3 * fwd / timed:.2f} ms, decode+NMS '
        f'{1e3 * dec / timed:.2f} ms; peak memory {mem:.2f} GiB; '
        f'launches in {warm + timed} requests: roi_align_rotated '
        f'{counts["roi_align_rotated"]}, nms_pair_mask '
        f'{counts["nms_pair_mask"]}')
    log(f'[orcnn-serving] RoIs per level {per_level}; (RoI, class) scores '
        f'past score_thr {over}; valid dets per image '
        f'{valid.sum(1).tolist()}')
    from orientedobjectdetection_torch.models.roi_heads import (
        oriented_roi_head)
    from orientedobjectdetection_torch.ops import nms
    with recording(nms, 'nms_pair_mask') as masks, \
            recording(oriented_roi_head, 'roi_align_rotated_pyramid') as pools:
        bundle(images)
    inputs = {'orcnn': (masks[0][0][0], masks[0][0][2]),
              'orcnn_roi': tuple(pools[0][0][:2])}

    def requests():
        for _ in range(split):
            bundle(images)

    prof = profile_run(requests, device, f'{split} oriented requests',
                       'two_stage.')
    if prof['busy_us']:
        b3_us = sum(us for name, us in prof['kernels'].items()
                    if 'roi_align_rotated_kernel' in name)
        b1_us = sum(us for name, us in prof['kernels'].items()
                    if 'pair_mask' in name)
        # the profiler credits a range with the kernels of the PyTorch
        # operators called inside it; what no range was credited with is
        # printed beside the port's own kernels, which PyTorch does not
        # launch
        spans = sum(prof['spans'].values())
        log(f'[profile] per request: roi_align_rotated '
            f'{b3_us / split / 1e3:.3f} ms (launched in '
            f'two_stage.roialign_head), nms_pair_mask '
            f'{b1_us / split / 1e3:.3f} ms (in two_stage.decode_nms); device '
            f'time outside the ranges\' sums '
            f'{(prof["busy_us"] - spans) / split / 1e3:.3f} ms')
    return counts, inputs


# ---- 13./14. Oriented R-CNN training ---------------------------------------
def build_orcnn_trainer(device, dtype, seed=0, plain_rpn=False,
                        plain_roi=False):
    """The Oriented R-CNN config's detector with seeded weights and the
    config's optimizer (SGD, momentum, weight decay, clip, linear warmup,
    frozen stem and stage 1), normalizing raw uint8 BGR images on the
    device. The regression outputs of both stages are scaled down, as in
    :func:`build_orcnn_bundle`, so proposals stay near their anchors.
    ``plain_rpn`` / ``plain_roi``: the RPN's or the RoI head's assigner
    computes its IoU matrix with the plain version (a reference run).
    Returns (detector, state, train_step)."""
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.parallel import (
        build_lr_schedule, build_optimizer, create_train_state,
        make_train_step)
    from orientedobjectdetection_torch.utils import Config
    cfg = Config.fromfile(ORCNN_CONFIG)
    detector = build_detector(dict(cfg.model))
    detector.rpn_head.assigner.plain_iou = plain_rpn
    detector.roi_head.assigner.plain_iou = plain_roi
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 steps_per_epoch=1000)
    tx = build_optimizer(dict(cfg.optimizer), schedule,
                         grad_clip=cfg.optimizer_config['grad_clip'],
                         frozen_stages=detector.backbone.frozen_stages)
    state = create_train_state(detector, tx, device=device, seed=seed)
    with torch.no_grad():
        detector.rpn_head.rpn_reg.weight.mul_(0.05)
        detector.roi_head.bbox_head.fc_reg.weight.mul_(0.05)
    step = make_train_step(detector, tx, device_norm=cfg.img_norm_cfg,
                           dtype=dtype)
    return detector, state, step


def orcnn_train_step(device, batch, plain_rpn, plain_roi) -> dict:
    """A fresh seeded float32 trainer takes one step (the default rng of
    step 0) on ``batch``, keeping the RPN's targets and the RoI head's
    sampling (their inputs and results). Returns the metrics as floats,
    those, each parameter before and after, and the detector."""
    detector, state, step = build_orcnn_trainer(
        device, torch.float32, plain_rpn=plain_rpn, plain_roi=plain_roi)
    before = {n: p.detach().clone() for n, p in detector.named_parameters()}
    with recording(detector.rpn_head, 'targets') as rpn, \
            recording(detector.roi_head, 'sample_rois') as rois:
        state, metrics = step(state, batch)
    sync(device)
    check_metrics(metrics)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                rpn=rpn[0], rois=rois[0], before=before,
                after={n: p.detach().clone()
                       for n, p in detector.named_parameters()},
                detector=detector)


def same_outputs(kernel, plain, names, label) -> None:
    """Equal tensors, the ``targets`` (float arithmetic on equal inputs)
    within 1e-5."""
    for name, got, ref in zip(names, kernel, plain):
        if name == 'targets' and float((got - ref).abs().max()) <= 1e-5:
            continue
        if not torch.equal(got, ref):
            raise AssertionError(f'{label} {name} differ between the kernel '
                                 f'and the plain matrix')


def same_steps(got, ref, label) -> float:
    """Two steps whose assigners agreed: the same sampled anchors and RoIs,
    labels, targets and losses, and parameters within PARAM_RTOL of each
    tensor's change; frozen tensors unchanged. Returns the largest
    difference relative to its tensor's change."""
    same_outputs(got['rpn'][1], ref['rpn'][1],
                 ('foreground', 'label weights', 'targets', 'box weights'),
                 f'{label}: RPN')
    same_outputs(got['rois'][1], ref['rois'][1],
                 ('RoIs', 'labels', 'label weights', 'targets',
                  'box weights', 'positives'), f'{label}: sampled')
    for k, v in ref['metrics'].items():
        if k != 'grad_norm' and abs(got['metrics'][k] - v) > \
                LOSS_RTOL * abs(v):
            raise AssertionError(f'{label}: {k} {got["metrics"][k]} vs {v}')
    worst = 0.0
    for n, before in ref['before'].items():
        moved = ref['after'][n] - before
        err = float((got['after'][n] - ref['after'][n]).abs().max())
        if not ref['detector'].get_parameter(n).requires_grad:
            if moved.any() or err:
                raise AssertionError(f'{n}: frozen tensor changed')
            continue
        scale = float(moved.abs().max())
        worst = max(worst, err / scale) if scale else worst
        if err > PARAM_RTOL * scale:
            raise AssertionError(f'{label}: {n} after the step differs by '
                                 f'{err} > {PARAM_RTOL} x {scale}')
    return worst


def phase_orcnn_train_slice(device, bsz=2, size=1024, g=32, valid=8) -> None:
    """float32: two-stage train steps from one seeded state and rng with the
    IoU-matrix kernel in both assigners, in neither (the plain matrix), and
    in the RoI head's only. The forward is the same in all three, so the
    proposals are equal. Each assigner gives the same assignment with the
    kernel as with the plain matrix, on the step's own inputs, except
    within ASSIGN_BAND of a threshold or of a gt's best IoU
    (:func:`check_assigner`): the RPN's axis-aligned gts and anchors make
    ties at a gt's best IoU common, and rounding breaks them either way.
    Where the assignments agree, the steps must agree (:func:`same_steps`):
    the kernel in the RoI head against the plain run always, and the kernel
    in both when the RPN's assignments agree as well."""
    from orientedobjectdetection_torch.ops.boxes import obb2hbb
    batch = train_batch(bsz, size, g, valid, 90, device)
    kernel = orcnn_train_step(device, batch, False, False)
    plain = orcnn_train_step(device, batch, True, True)
    roi_only = orcnn_train_step(device, batch, True, False)
    det = kernel['detector']
    (proposals, prop_valid, gts, labels, mask, _), rois = kernel['rois']
    for run in (plain, roi_only):
        if not (torch.equal(proposals, run['rois'][0][0]) and
                torch.equal(prop_valid, run['rois'][0][1])):
            raise AssertionError('the proposals differ between the steps')
    rpn_pos, rpn_differ = check_assigner(
        det.rpn_head.assigner, kernel['rpn'][0][1],
        obb2hbb(gts.float(), det.rpn_head.version),
        torch.zeros_like(labels), mask)
    roi_pos, roi_differ = check_assigner(
        det.roi_head.assigner, torch.cat([gts.float(), proposals], 1),
        gts.float(), labels, mask)
    if roi_differ:
        raise AssertionError(f'{roi_differ} RoIs assigned differently (in '
                             f'the band), so the steps cannot be held equal')
    worst = {'RoI head kernel vs plain': same_steps(roi_only, plain,
                                                    'RoI head kernel')}
    if rpn_differ == 0:
        worst['both kernels vs plain'] = same_steps(kernel, plain,
                                                    'both kernels')
    fg, lw = kernel['rpn'][1][0], kernel['rpn'][1][1]
    if rois[4].sum() < 1 or fg.sum() < 1:
        raise AssertionError('the batch has no positive anchor or RoI')
    log(f'[orcnn-train-slice] float32 B={bsz} {size}^2, G={g} ({valid} '
        f'valid): assignments with the kernel and the plain matrix differ at '
        f'{rpn_differ} anchors ({rpn_pos} positive) and {roi_differ} RoIs '
        f'({roi_pos} positive), all within {ASSIGN_BAND} of a threshold or '
        f'of a gt\'s best IoU; {int(fg.sum())} positive anchors sampled of '
        f'{int(lw.sum())}, {int(rois[4].sum())} positive RoIs of '
        f'{int(rois[2].sum())}; equal sampled sets, labels, targets and '
        f'losses (rtol {LOSS_RTOL}) and parameters within '
        + ', '.join(f'{v:.3g} ({k})' for k, v in worst.items()) +
        f' of each tensor\'s change (limit {PARAM_RTOL}); losses with both '
        f'kernels {kernel["metrics"]}, plain {plain["metrics"]}')


def syncs_inside(prof, ranges, watch=SYNC_EVENTS) -> dict:
    """Events named in ``watch`` that ran inside a ``record_function``
    range named in ``ranges``, on its thread, each with the host operators
    around it, outermost first. Returns range name -> ['event in op > op',
    ...]. The ranges are their host-side spans: a range's device-side span
    (first to last of its kernels, on the device's clock) also carries its
    name, and the host may be running later operators by then."""
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    spans = [e for e in events if e.name in ranges and e.device_type != cuda]
    found = {name: [] for name in ranges}

    def inside(e, outer):
        return e.thread == outer.thread and \
            outer.time_range.start <= e.time_range.start and \
            e.time_range.end <= outer.time_range.end

    for e in events:
        if e.name not in watch:
            continue
        for span in spans:
            if inside(e, span):
                around = sorted((o for o in events if o is not e and
                                 o.name.startswith('aten::') and
                                 inside(e, o)),
                                key=lambda o: o.time_range.start)
                chain = ' > '.join(o.name for o in around) or span.name
                found[span.name].append(f'{e.name} in {chain}')
    return found


def phase_orcnn_training(device, card='', bsz=8, size=1024, g=32, valid=8,
                         warm=3, timed=10, dtype=torch.bfloat16,
                         record=True, reps=20) -> tuple:
    """``warm + timed`` two-stage train steps on one fixed batch. Returns
    the kernels' launch counts of this run and, with ``record``, the inputs
    of both IoU-matrix launches (boxes1, boxes2, mode) of one more step,
    under ``'orcnn_train_rpn'`` and ``'orcnn_train_roi'``. With ``record``
    that step also keeps the RoI pooling's inputs, on which the gather
    pooling's forward and backward are timed alone (``reps`` runs each),
    and one more step runs under the profiler."""
    on_card = torch.device(device).type == 'cuda'
    detector, state, step = build_orcnn_trainer(device, dtype)
    batch = train_batch(bsz, size, g, valid, 100, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    history = []
    for _ in range(warm):
        state, metrics = step(state, batch)
        history.append(metrics)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(timed):
        state, metrics = step(state, batch)
        history.append(metrics)
    sync(device)
    seconds = time.perf_counter() - t0
    counts = read_launches()
    steps = warm + timed
    expected = {'box_iou_rotated': 2 * steps if on_card else 0,
                'roi_align_rotated': 0, 'nms_pair_mask': 0}
    if counts != expected:
        raise AssertionError(f'launches in {steps} two-stage steps: {counts}'
                             f', expected {expected} (two assigners a step; '
                             f'training pools outside the RoIAlign kernel)')
    for metrics in history:
        check_metrics(metrics)
    losses = [float(m['loss']) for m in history]
    if not losses[-1] < losses[0]:
        raise AssertionError(f'the loss did not fall on the fixed batch: '
                             f'{losses}')
    mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
        else float('nan')
    log(f'[orcnn-training] {card} | {str(dtype).split(".")[-1]} B={bsz} '
        f'{size}^2, G={g} ({valid} valid), {timed} timed steps after {warm} '
        f'warm: {bsz * timed / seconds:.2f} imgs/s, '
        f'{1e3 * seconds / timed:.2f} ms per step; peak memory {mem:.2f} GiB; '
        f'box_iou_rotated launches {counts["box_iou_rotated"]} in {steps} '
        f'steps ({counts["box_iou_rotated"] / steps:g} per step)')
    first, last = history[0], history[-1]
    log(f'[orcnn-training] loss {losses[0]:.4f} -> {losses[-1]:.4f} ' +
        ', '.join(f'{k} {float(first[k]):.4f} -> {float(last[k]):.4f}'
                  for k in ('loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
                            'loss_bbox')) +
        f'; grad_norm {float(first["grad_norm"]):.3f} -> '
        f'{float(last["grad_norm"]):.3f}')
    if not record:
        return counts, {}
    from orientedobjectdetection_torch.models.roi_heads import (
        oriented_roi_head)
    from orientedobjectdetection_torch.ops import iou_kernels
    with recording(iou_kernels, 'box_iou_rotated_matrix') as calls, \
            recording(oriented_roi_head, 'roi_align_rotated') as pools:
        state, _ = step(state, batch)
    # the RoI head samples in the forward, the RPN assigns in the loss:
    # the RPN's columns are the anchors, shared by the batch
    rpn = [args for args, _ in calls if args[1].dim() == 2]
    roi = [args for args, _ in calls if args[1].dim() == 3]
    if len(rpn) != 1 or len(roi) != 1:
        raise AssertionError(f'{len(calls)} IoU matrices in one step')
    time_gather_pooling(pools[0][0], device, card, reps)
    profile_orcnn_step(lambda: step(state, batch), device)
    return counts, {'orcnn_train_rpn': rpn[0], 'orcnn_train_roi': roi[0]}


def time_gather_pooling(args, device, card, reps, label='orcnn') -> dict:
    """The training path's RoI pooling (the gather formulation) alone on
    one step's levels and sampled RoIs: its forward, and its backward into
    the levels, each over ``reps`` runs (ms)."""
    from orientedobjectdetection_torch.ops.roi_align_rotated import (
        roi_align_rotated)
    levels = [f.detach().requires_grad_() for f in args[0]]
    rest = (args[1].detach(),) + tuple(args[2:])
    fwd = time_ms(lambda: roi_align_rotated(levels, *rest), reps, device,
                  warmup=1)
    pooled = roi_align_rotated(levels, *rest)
    grad = torch.ones_like(pooled)
    bwd = time_ms(lambda: torch.autograd.grad(pooled, levels, grad,
                                              retain_graph=True),
                  reps, device, warmup=1)
    rois = rest[0]
    log(f'[{label}-training] {card} | gather RoI pooling alone, B='
        f'{rois.shape[0]} R={rois.shape[1]} C={levels[0].shape[-1]} '
        f'{str(levels[0].dtype).split(".")[-1]}: forward {fwd:.3f} ms, '
        f'backward {bwd:.3f} ms')
    return dict(forward_ms=fwd, backward_ms=bwd)


def profile_orcnn_step(step, device) -> None:
    """One two-stage step under the profiler, split by the ``train.*`` and
    ``two_stage.*`` ranges; the two IoU-matrix launches and the gather
    pooling's backward (autograd's GatherBackward0 nodes) are read from it.
    Fails if a host read of a device value ran inside
    ``two_stage.rpn_targets`` or ``two_stage.sample_rois``."""
    prof = profile_run(step, device, 'two-stage train step',
                       ('train.', 'two_stage.'))
    sampler = ('two_stage.rpn_targets', 'two_stage.sample_rois')
    found = syncs_inside(prof['prof'], sampler)
    if any(found.values()):
        raise AssertionError(f'host synchronisation inside the sampler: '
                             f'{found}')
    copies = {k: dict(collections.Counter(v)) for k, v in syncs_inside(
        prof['prof'], sampler, ('cudaMemcpyAsync',)).items()}
    log(f'[profile] no host synchronisation inside two_stage.rpn_targets or '
        f'two_stage.sample_rois; asynchronous copies there: {copies}')
    if not prof['busy_us']:
        return
    spans = prof['spans']
    named = sum(spans.get(k, 0) for k in
                ('train.forward', 'train.loss', 'train.update'))
    b2_us = sum(us for name, us in prof['kernels'].items()
                if 'iou_matrix_kernel' in name)
    gather_us = sum(us for name, us in prof['ops'].items()
                    if 'GatherBackward' in name)
    log(f'[profile] device time: forward '
        f'{spans.get("train.forward", 0) / 1e3:.2f} ms (network + RPN '
        f'{spans.get("two_stage.network_rpn", 0) / 1e3:.2f}, proposals '
        f'{spans.get("two_stage.proposals", 0) / 1e3:.2f}, sample_rois '
        f'{spans.get("two_stage.sample_rois", 0) / 1e3:.2f}, roi_pool '
        f'{spans.get("two_stage.roi_pool", 0) / 1e3:.2f}), targets + loss '
        f'{spans.get("train.loss", 0) / 1e3:.2f} ms (rpn_targets '
        f'{spans.get("two_stage.rpn_targets", 0) / 1e3:.2f}, roi_loss '
        f'{spans.get("two_stage.roi_loss", 0) / 1e3:.2f}), optimizer '
        f'{spans.get("train.update", 0) / 1e3:.2f} ms, backward (the rest) '
        f'{(prof["busy_us"] - named) / 1e3:.2f} ms; box_iou_rotated '
        f'{b2_us / 1e3:.3f} ms (two launches); the gather pooling\'s '
        f'GatherBackward0 nodes {gather_us / 1e3:.2f} ms')


# ---- 15.-18. data, the trainer and the evaluator ---------------------------
def synth_config(path, root):
    """A synthetic-data config with its ``data_root`` moved to ``root``."""
    from orientedobjectdetection_torch.tools.train import load_config
    return load_config(path, [f'data_root={root}/'])


def annotation_polys(ann_dir) -> dict:
    """Image stem -> its annotation polygons (n, 8), as the files hold
    them."""
    polys = {}
    for name in sorted(os.listdir(ann_dir)):
        with open(os.path.join(ann_dir, name)) as f:
            rows = [line.split()[:8] for line in f if line.strip()]
        polys[name[:-4]] = np.asarray(rows, np.float32).reshape(-1, 8)
    return polys


def check_round_trip(polys, version) -> float:
    """Each polygon -> ``poly2obb_np`` -> ``obb2poly_np`` gives back its
    corners within ROUND_TRIP_ATOL (the files round them to 0.1 px), in any
    cyclic order. Returns the largest corner distance."""
    from orientedobjectdetection_torch.ops.boxes import (obb2poly_np,
                                                         poly2obb_np)
    worst = 0.0
    for poly in polys:
        obb = poly2obb_np(poly, version)
        if obb is None:
            raise AssertionError(f'poly2obb_np rejected {poly.tolist()}')
        back = obb2poly_np(np.asarray([list(obb) + [0.0]]), version)[0, :8]
        pts, got = poly.reshape(4, 2), back.reshape(4, 2)
        err = min(float(np.abs(np.roll(got, s, 0) - pts).max())
                  for s in range(4))
        worst = max(worst, err)
    if worst > ROUND_TRIP_ATOL:
        raise AssertionError(f'polygons round-trip to within {worst} px')
    return worst


def phase_data(root, card='', config=SYNTH1024_CONFIG, size=1024,
               n_train=16, n_val=8, n_range=(100, 600), epochs=2) -> float:
    """Generate a synth-hard set with the port's generator, build the
    synth1024 config's datasets on it, time its DataLoader alone (uint8,
    the config's batch and ``max_gt``) and check the batches: shapes, no
    annotation lost (kept or in the ignore slots), polygons that
    round-trip. Returns the loader's imgs/s."""
    import shutil
    from orientedobjectdetection_torch.datasets import (
        DataLoader, build_dataset, strip_host_normalize)
    from orientedobjectdetection_torch.tools.generate_synth import \
        generate_synth_hard
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    generate_synth_hard(root, n_train, size, seed=0, split='trainval',
                        n_range=n_range)
    generate_synth_hard(root, n_val, size, seed=1, split='val',
                        n_range=n_range)
    gen_s = time.perf_counter() - t0
    cfg = synth_config(config, root)
    train_cfg, norm = strip_host_normalize(cfg.data['train'])
    if norm is None:
        raise AssertionError('the config has no Normalize to move')
    dataset = build_dataset(train_cfg, seed=0)
    val = build_dataset(dict(cfg.data['val'], test_mode=True,
                             filter_empty_gt=False))
    if (len(dataset), len(val)) != (n_train, n_val):
        raise AssertionError(f'{len(dataset)} train, {len(val)} val images')
    bsz, max_gt = int(cfg.data['samples_per_gpu']), int(cfg.data['max_gt'])
    pad_h, pad_w = cfg.data['pad_size']
    loader = DataLoader(dataset, bsz, max_gt=max_gt,
                        pad_size=cfg.data['pad_size'],
                        num_workers=int(cfg.data['workers_per_gpu']) * 4,
                        seed=0)
    polys = annotation_polys(os.path.join(root, 'trainval', 'annfiles'))
    seen, overflow = 0, 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        for batch in loader:
            shapes = {k: tuple(v.shape) for k, v in batch.items()
                      if k != 'img_metas'}
            want = {'images': (bsz, pad_h, pad_w, 3),
                    'gt_bboxes': (bsz, max_gt, 5), 'gt_labels': (bsz, max_gt),
                    'gt_mask': (bsz, max_gt), 'gt_ignore': (bsz, max_gt, 5),
                    'gt_ignore_mask': (bsz, max_gt)}
            if shapes != want or batch['images'].dtype != torch.uint8:
                raise AssertionError(f'batch {shapes} '
                                     f'{batch["images"].dtype}')
            kept = batch['gt_mask'].sum(1) + batch['gt_ignore_mask'].sum(1)
            for meta, n in zip(batch['img_metas'], kept.tolist()):
                # the loader keeps max_gt and masks up to max_gt more
                stem = os.path.basename(meta['filename'])[:-4]
                if n != min(len(polys[stem]), 2 * max_gt):
                    raise AssertionError(f'{stem}: {n} of '
                                         f'{len(polys[stem])} annotations')
            overflow += int(batch['gt_ignore_mask'].any(1).sum())
            seen += bsz
    seconds = time.perf_counter() - t0
    worst = check_round_trip(np.concatenate(list(polys.values())),
                             train_cfg['version'])
    log(f'[data] {n_train} + {n_val} synth-hard images of {size}^2 '
        f'({sum(map(len, polys.values()))} train instances, '
        f'{n_range[0]}-{n_range[1]} an image) generated in {gen_s:.1f} s; '
        f'DataLoader alone, uint8 B={bsz} max_gt={max_gt}, '
        f'{loader.num_workers} threads, {epochs} epochs: {seen / seconds:.2f} '
        f'imgs/s on the host of {card}; every annotation kept or in '
        f'gt_ignore, up to 2 x max_gt ({overflow} images over max_gt); '
        f'polygons round-trip '
        f'within {worst:.3f} px')
    return seen / seconds


@contextlib.contextmanager
def launches_before_eval():
    """Record the launch counts at each call of the trainer's
    ``eval_from_state`` (what training alone launched)."""
    from orientedobjectdetection_torch.apis import train as train_api
    original, seen = train_api.eval_from_state, []

    def counted(*args, **kwargs):
        seen.append(read_launches())
        return original(*args, **kwargs)

    train_api.eval_from_state = counted
    try:
        yield seen
    finally:
        train_api.eval_from_state = original


def read_train_log(work_dir) -> list:
    with open(os.path.join(work_dir, 'train_log.jsonl')) as f:
        return [json.loads(line) for line in f]


def run_trainer(cfg, work_dir, steps, device, dtype, per_step,
                log_interval) -> tuple:
    """``train_detector`` for ``steps`` steps from scratch, its evaluation
    and checkpoint forced to the last epoch. Checks its launches of the
    IoU-matrix kernel (``per_step`` a step before the evaluation), finite
    losses, the val line and the checkpoints. Returns (state, launch counts
    of the run, seconds, the log)."""
    import shutil
    from orientedobjectdetection_torch.apis.train import train_detector
    from orientedobjectdetection_torch.datasets import build_dataset
    on_card = torch.device(device).type == 'cuda'
    shutil.rmtree(work_dir, ignore_errors=True)
    per_epoch = len(build_dataset(cfg.data['train'])) // \
        int(cfg.data['samples_per_gpu'])
    epochs = steps // per_epoch
    if epochs < 1 or steps % per_epoch:
        raise ValueError(f'{steps} steps are not whole epochs of '
                         f'{per_epoch}')
    cfg = cfg.copy()
    cfg.merge_from_dict({'evaluation.interval': epochs,
                         'checkpoint_config.interval': epochs})
    reset_launches()
    t0 = time.perf_counter()
    with launches_before_eval() as at_eval:
        state = train_detector(cfg, work_dir, max_steps=steps,
                               log_interval=log_interval, dtype=dtype,
                               device=device)
    sync(device)
    seconds = time.perf_counter() - t0
    counts = read_launches()
    if state.step != steps or len(at_eval) != 1:
        raise AssertionError(f'{state.step} steps, {len(at_eval)} evals')
    trained = at_eval[0]['box_iou_rotated']
    if trained != (per_step * steps if on_card else 0):
        raise AssertionError(f'box_iou_rotated launched {trained} times in '
                             f'{steps} steps')
    log_lines = read_train_log(work_dir)
    losses = [r['loss'] for r in log_lines if 'loss' in r]
    if len(losses) != steps // log_interval or \
            not np.isfinite(losses).all():
        raise AssertionError(f'logged losses {losses}')
    val = [r for r in log_lines if r.get('mode') == 'val']
    if len(val) != 1 or not 0 <= val[0]['mAP'] <= 1:
        raise AssertionError(f'val lines {val}')
    files = sorted(os.listdir(work_dir))
    if f'ckpt_{steps:08d}.pth' not in files or \
            f'best_{steps:08d}.pth' not in files:
        raise AssertionError(f'work dir holds {files}')
    return state, counts, seconds, log_lines


def phase_trainer(root, work_dir, card='', config=SYNTH1024_CONFIG,
                  steps=20, extra=2, dtype=torch.bfloat16, device='cuda',
                  log_interval=5, bare_steps=10,
                  synthetic_rate=None) -> tuple:
    """``train_detector`` on the synth1024 config (R50-FPN RetinaNet, 15
    classes, 1024^2, batch 8, max_gt 512) for ``steps`` steps with the
    evaluation at the end; then a resume from its checkpoint with no step
    (the parameters and the step carry over exactly) and one for ``extra``
    steps more. Compares the loop's imgs/s with the same step on one of
    the loader's batches alone and with phase 8's synthetic batch. Returns
    the launch counts of the first run and its final state dict."""
    from orientedobjectdetection_torch.apis.train import (setup_training,
                                                          train_detector)
    on_card = torch.device(device).type == 'cuda'
    cfg = synth_config(config, root)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state, counts, seconds, log_lines = run_trainer(
        cfg, work_dir, steps, device, dtype, 1, log_interval)
    mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
        else float('nan')
    rates = [r['imgs_per_sec'] for r in log_lines if 'imgs_per_sec' in r]
    loop_rate = float(np.mean(rates[1:] or rates))
    trained = {k: v.detach().clone() for k, v in
               state.model.state_dict().items()}
    ckpt = os.path.join(work_dir, f'ckpt_{steps:08d}.pth')
    again = train_detector(cfg, work_dir, resume_from=ckpt, max_steps=steps,
                           dtype=dtype, device=device)
    if again.step != steps:
        raise AssertionError(f'resumed at step {again.step}')
    for k, v in again.model.state_dict().items():
        if not torch.equal(v, trained[k]):
            raise AssertionError(f'{k} changed on resume')
    further = train_detector(cfg, work_dir, resume_from=ckpt,
                             max_steps=steps + extra, log_interval=1,
                             dtype=dtype, device=device)
    tail = [r['step'] for r in read_train_log(work_dir)[-extra:]]
    if further.step != steps + extra or \
            tail != list(range(steps + 1, steps + extra + 1)):
        raise AssertionError(f'resume went on to step {further.step}, '
                             f'logged {tail}')
    # the trainer's own step alone on one of its loader's batches
    setup = setup_training(cfg, dtype=dtype, device=device)
    batch = next(iter(setup.loader))
    batch.pop('img_metas')
    bare, step = setup.state, setup.step_fn
    for _ in range(3):
        bare, _ = step(bare, batch)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(bare_steps):
        bare, metrics = step(bare, batch)
    sync(device)
    check_metrics(metrics)
    bsz = batch['images'].shape[0]
    bare_rate = bsz * bare_steps / (time.perf_counter() - t0)
    val = [r for r in log_lines if r.get('mode') == 'val'][0]
    synthetic = f'{synthetic_rate:.2f}' if synthetic_rate else 'not run'
    log(f'[trainer] {card} | train_detector, {os.path.basename(config)} '
        f'({bsz} x {cfg.data["pad_size"]}, max_gt {cfg.data["max_gt"]}), '
        f'{str(dtype).split(".")[-1]}, {steps} steps + eval: {seconds:.1f} s'
        f'; loop {loop_rate:.2f} imgs/s (log intervals {rates}) against '
        f'{bare_rate:.2f} for the same step alone on one loader batch and '
        f'{synthetic} for phase 8\'s synthetic batch (G=32); peak memory '
        f'{mem:.2f} GiB; launches {counts}; loss {log_lines[0]["loss"]:.4f} '
        f'-> {[r for r in log_lines if "loss" in r][-1]["loss"]:.4f}; val '
        f'mAP {val["mAP"]:.4f}; resume from {os.path.basename(ckpt)}: step '
        f'and {len(trained)} tensors equal, then steps {tail}')
    return counts, trained


def stack_results(results, num_classes):
    """Per-image, per-class (n, 6) arrays -> padded (dets, labels, valid)
    tensors, the bundle's form."""
    rows = [np.concatenate([r[c] for c in range(num_classes)])
            for r in results]
    labels = [np.concatenate([np.full(len(r[c]), c) for c in
                              range(num_classes)]) for r in results]
    n = max(max(len(r) for r in rows), 1)
    dets = torch.zeros(len(rows), n, 6)
    lab = torch.full((len(rows), n), -1, dtype=torch.long)
    for i, (d, lb) in enumerate(zip(rows, labels)):
        dets[i, :len(d)] = torch.from_numpy(d)
        lab[i, :len(d)] = torch.from_numpy(lb)
    return dets, lab, lab >= 0


def phase_evaluator(root, state_dict, card='', config=SYNTH1024_CONFIG,
                    device='cuda') -> dict:
    """``eval_from_state`` on the synth1024 val images (float32, the
    trained weights with the class bias zeroed so that scores pass
    score_thr, as phase 5 does), then the same images with the kernels and
    with their plain versions (B1 in the NMS, B2 in ``eval_rbbox_map``):
    the same detections up to near-ties, per-class AP within AP_ATOL.
    Returns the launch counts of the ``eval_from_state`` run and the
    kernel run's inputs of the IoU matrix, one a class, which phase 12
    holds against the plain matrix."""
    from orientedobjectdetection_torch.apis.eval import (
        _default_norm, batched_eval, eval_from_state)
    from orientedobjectdetection_torch.apis.inference import init_detector
    from orientedobjectdetection_torch.core.eval_map import eval_rbbox_map
    from orientedobjectdetection_torch.datasets import build_dataset
    on_card = torch.device(device).type == 'cuda'
    cfg = synth_config(config, root)
    val = build_dataset(dict(cfg.data['val'], test_mode=True,
                             filter_empty_gt=False))
    weights = dict(state_dict)
    weights['bbox_head.retina_cls.bias'] = torch.zeros_like(
        weights['bbox_head.retina_cls.bias'])
    bundle = init_detector(cfg, weights, device=device,
                           device_norm=_default_norm(cfg))
    reset_launches()
    ev = eval_from_state(bundle, weights, val, batch_size=8)
    sync(device)
    counts = read_launches()
    if on_card and min(counts['nms_pair_mask'],
                       counts['box_iou_rotated']) < 1:
        raise AssertionError(f'eval launches {counts}')
    anns = [val.get_ann_info(i) for i in range(len(val))]
    from orientedobjectdetection_torch.ops import iou_kernels
    runs = {}
    for plain in (False, True):
        bundle.plain_pair_mask = plain
        results = batched_eval(bundle, val, batch_size=8, progress=False)
        with recording(iou_kernels, 'box_iou_rotated_matrix') as calls:
            runs[plain] = (results, *eval_rbbox_map(
                results, anns, device=device, plain_iou=plain,
                logger='silent'))
        if not plain:
            matrices = [args for args, _ in calls]
    if not matrices or len(calls):
        raise AssertionError(f'{len(matrices)} IoU matrices with the '
                             f'kernel, {len(calls)} with the plain version')
    (got, got_map, got_aps), (ref, ref_map, ref_aps) = runs[False], \
        runs[True]
    err, moved, aside = same_detections(
        stack_results(got, bundle.num_classes),
        stack_results(ref, bundle.num_classes), [-1.0] * len(got))
    gaps = [abs(g['ap'] - r['ap']) for g, r in zip(got_aps, ref_aps)]
    if max(gaps) > AP_ATOL or abs(got_map - ev['mAP']) > AP_ATOL:
        raise AssertionError(f'per-class AP kernel vs plain differ by '
                             f'{max(gaps)}; mAP {got_map} vs '
                             f'eval_from_state {ev["mAP"]}')
    n_dets = sum(len(c) for r in got for c in r)
    log(f'[evaluator] {card} | eval_from_state on {len(val)} val images: '
        f'mAP {ev["mAP"]:.4f}, launches {counts}; kernels vs plain (B1 in '
        f'NMS, B2 in eval_rbbox_map): {n_dets} detections the same (max '
        f'|diff| {err:.3g}, {moved} rows moved), per-class AP within '
        f'{max(gaps):.3g} (mAP {got_map:.6f} vs {ref_map:.6f}); '
        f'{len(matrices)} IoU matrices recorded for phase 12')
    return counts, {'eval_iou': matrices}


def phase_orcnn_loop(root, work_dir, card='', config=ORCNN_TINY_CONFIG,
                     n_images=40, size=256, steps=20, dtype=torch.bfloat16,
                     device='cuda', log_interval=5) -> dict:
    """``oriented_rcnn_tiny_synth.py`` through ``train_detector`` on a
    tiny-synth set from the port's generator: ``steps`` steps, two
    IoU-matrix launches a step, then the evaluation, where the RoIAlign
    kernel runs. Returns the run's launch counts and every input it gave
    the kernels (the RPN and RoI assigners' matrices, and in the
    evaluation the NMS candidates, the RoIAlign levels and RoIs and the
    IoU matrices of ``eval_rbbox_map``), which phase 12 holds against
    their plain versions."""
    import shutil
    from orientedobjectdetection_torch.models.roi_heads import (
        oriented_roi_head)
    from orientedobjectdetection_torch.ops import iou_kernels, nms
    from orientedobjectdetection_torch.tools.generate_synth import \
        generate_synth
    on_card = torch.device(device).type == 'cuda'
    shutil.rmtree(root, ignore_errors=True)
    generate_synth(root, n_images, size, seed=0)
    cfg = synth_config(config, root)
    with recording(iou_kernels, 'box_iou_rotated_matrix') as matrices, \
            recording(nms, 'nms_pair_mask') as masks, \
            recording(oriented_roi_head, 'roi_align_rotated_pyramid') as \
            pools:
        state, counts, seconds, log_lines = run_trainer(
            cfg, work_dir, steps, device, dtype, 2, log_interval)
    if on_card and min(counts['roi_align_rotated'],
                       counts['nms_pair_mask']) < 1:
        raise AssertionError(f'launches {counts}')
    # a step assigns the RoI head's proposals (B, R, 5) and the RPN's
    # anchors (shared by the batch: 2-D); the evaluation's matrices follow
    train, evals = matrices[:2 * steps], matrices[2 * steps:]
    rpn = [args for args, _ in train if args[1].dim() == 2]
    roi = [args for args, _ in train if args[1].dim() == 3]
    if (len(rpn), len(roi)) != (steps, steps) or not evals or not masks \
            or not pools:
        raise AssertionError(
            f'recorded {len(matrices)} IoU matrices, {len(masks)} pair '
            f'masks and {len(pools)} poolings in {steps} steps + eval')
    inputs = {'orcnn_loop_rpn': rpn, 'orcnn_loop_roi': roi,
              'orcnn_loop_eval_iou': [args for args, _ in evals],
              'orcnn_loop_nms': [(args[0], args[2]) for args, _ in masks],
              'orcnn_loop_roi_align': [tuple(args[:2]) for args, _ in
                                       pools]}
    val = [r for r in log_lines if r.get('mode') == 'val'][0]
    losses = [r['loss'] for r in log_lines if 'loss' in r]
    log(f'[orcnn-loop] {card} | train_detector, {os.path.basename(config)} '
        f'({n_images} images of {size}^2), '
        f'{str(dtype).split(".")[-1]}, {steps} steps + eval: {seconds:.1f} '
        f's; loss {losses[0]:.4f} -> {losses[-1]:.4f}; val mAP '
        f'{val["mAP"]:.4f}; launches {counts}')
    return counts, inputs


# ---- 19.-22. huge images, flips, the submission, augmenting training -------
HRSC_CONFIG = os.path.join(ROOT, 'configs', 'hrsc',
                           'rotated_retinanet_obb_r50_fpn_6x_hrsc_rr_le90.py')
# from this N on, phase 12 holds a pair mask in blocks of MERGE_ROWS rows
# (a merge's (1, N, N) mask, and an (N, N) float IoU, reach gigabytes)
BIG_N = 8192
MERGE_ROWS = 128


def pair_mask_inputs(calls) -> list:
    """Recorded pair-mask calls -> (boxes, class ids), zeros for a call
    without class ids (what the wrapper itself puts there)."""
    out = []
    for args, _ in calls:
        boxes, _, cls = args
        if cls is None:
            cls = torch.zeros(boxes.shape[:2], dtype=torch.int32,
                              device=boxes.device)
        out.append((boxes, cls))
    return out


def greedy_rounds(boxes, cls) -> int:
    """Rounds ``ops/nms.py:greedy_suppress`` takes to its fixpoint on the
    kernel's mask of these inputs (its loop, counted)."""
    from orientedobjectdetection_torch.ops.iou_kernels import nms_pair_mask
    over = nms_pair_mask(boxes, IOU_THR, cls).bool()
    keep = torch.ones(over.shape[:2], dtype=torch.bool, device=over.device)
    for rounds in range(1, over.shape[1] + 1):
        new = ~(over & keep[:, :, None]).any(1)
        if torch.equal(new, keep):
            return rounds
        keep = new
    return over.shape[1]


@contextlib.contextmanager
def timed_calls(obj, name, spans, key, device):
    """Put a wrapper in place of ``obj.name`` that adds the synchronized
    seconds of each call to ``spans[key]``; restore the name after."""
    own = name in vars(obj)
    original = getattr(obj, name)

    def run(*args, **kwargs):
        sync(device)
        t0 = time.perf_counter()
        out = original(*args, **kwargs)
        sync(device)
        spans[key] += time.perf_counter() - t0
        return out

    setattr(obj, name, run)
    try:
        yield
    finally:
        if own:
            setattr(obj, name, original)
        else:
            delattr(obj, name)


def per_class_dets(results, num_classes, size) -> int:
    """Per-class ``(n, 6)`` results are finite, their centres within
    ``size`` of a ``size``^2 image, one array a class. Returns the number
    of detections."""
    if len(results) != num_classes:
        raise AssertionError(f'{len(results)} classes')
    total = 0
    for dets in results:
        if dets.ndim != 2 or dets.shape[1] != 6 or \
                not np.isfinite(dets).all():
            raise AssertionError(f'detections {dets.shape}')
        if len(dets) and (dets[:, :2].min() < -size or
                          dets[:, :2].max() > 2 * size):
            raise AssertionError('a detection far outside the image')
        total += len(dets)
    return total


def phase_patches(device, card='', size=4000, window=1024, step=824, bsz=8,
                  dtype=torch.bfloat16, max_candidates=2000,
                  seed=30) -> tuple:
    """``inference_detector_by_patches`` on one ``size``^2 uint8 image
    (DOTA's upper size) with phase 5's bundle, windows of ``window`` at
    ``step`` (25 at the defaults), ``bsz`` windows a batch: once to warm,
    once counted and timed (tile forward, tile decode + NMS, the merge),
    once with the plain pair mask, which gives the same merged detections.
    Returns the counted run's launches and the merge's pair-mask inputs,
    which phase 12 holds."""
    from orientedobjectdetection_torch.apis import DetectorBundle
    from orientedobjectdetection_torch.apis import inference as api
    from orientedobjectdetection_torch.core.patch import slide_window
    from orientedobjectdetection_torch.ops import nms
    on_card = torch.device(device).type == 'cuda'
    bundle = build_bundle(device, dtype, max_candidates)
    plain = DetectorBundle(bundle.cfg, bundle.detector, dtype,
                           device_norm=bundle.device_norm,
                           plain_pair_mask=True)
    img = np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                               np.uint8)
    n_windows = len(slide_window(size, size, [window], [step]))
    n_batches = -(-n_windows // bsz)
    kwargs = dict(sizes=(window,), steps=(step,), bs=bsz)
    api.inference_detector_by_patches(bundle, img, **kwargs)        # warm
    spans = collections.defaultdict(float)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with timed_calls(bundle, 'forward', spans, 'forward', device), \
            timed_calls(bundle, 'decode', spans, 'decode', device), \
            timed_calls(api, 'translate_and_merge', spans, 'merge', device), \
            recording(nms, 'nms_pair_mask', keep_results=False) as calls:
        reset_launches()
        t0 = time.perf_counter()
        got = api.inference_detector_by_patches(bundle, img, **kwargs)
        sync(device)
        wall = time.perf_counter() - t0
        counts = read_launches()
    mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
        else float('nan')
    n_dets = per_class_dets(got, bundle.num_classes, size)
    merge_calls = pair_mask_inputs(calls[n_batches:])   # after the tiles'
    # one launch a tile batch, then one a class in the merge
    expected = n_batches + len(merge_calls) if on_card else 0
    if counts['nms_pair_mask'] != expected or not merge_calls:
        raise AssertionError(f'launches {counts} for {n_batches} tile '
                             f'batches and {len(merge_calls)} merge NMS '
                             f'calls')
    ref = api.inference_detector_by_patches(plain, img, **kwargs)
    err, moved, aside = same_detections(
        stack_results([got], bundle.num_classes),
        stack_results([ref], bundle.num_classes), [-1.0])
    sizes = sorted((b.shape[1] for b, _ in merge_calls), reverse=True)
    largest = max(merge_calls, key=lambda c: c[0].shape[1])
    rounds = greedy_rounds(*largest)
    other = wall - spans['forward'] - spans['decode'] - spans['merge']
    log(f'[patches] {card} | inference_detector_by_patches, '
        f'{str(dtype).split(".")[-1]}, one {size}^2 image, {n_windows} '
        f'windows of {window} at step {step} in {n_batches} batches of up '
        f'to {bsz}: {1e3 * wall:.1f} ms an image = tile forward '
        f'{1e3 * spans["forward"]:.1f} + tile decode+NMS '
        f'{1e3 * spans["decode"]:.1f} + merge {1e3 * spans["merge"]:.1f} + '
        f'tile cuts and copies {1e3 * other:.1f} ms; {n_dets} merged '
        f'detections; merge NMS per class N {sizes} (largest {sizes[0]}, '
        f'{rounds} greedy rounds); nms_pair_mask launches {counts} '
        f'({len(merge_calls)} in the merge); peak memory {mem:.2f} GiB; '
        f'the plain pair mask gives the same detections (max |diff| '
        f'{err:.3g}, {moved} rows moved)')
    return counts, {'patch_merge': merge_calls}


def phase_tta(device, card='', n_images=3, size=1024, dtype=torch.bfloat16,
              max_candidates=2000, seed=31) -> dict:
    """``inference_detector_tta`` (the image, its horizontal and vertical
    flips, per-class NMS of the mapped detections) on ``n_images`` batch-1
    ``size``^2 uint8 images with phase 5's bundle, on a canvas of the
    images' size: counted and timed, then with the plain pair mask, which
    gives the same detections. Returns the counted run's launches."""
    from orientedobjectdetection_torch.apis import (DetectorBundle,
                                                    inference_detector_tta)
    on_card = torch.device(device).type == 'cuda'
    bundle = build_bundle(device, dtype, max_candidates)
    bundle.cfg.merge_from_dict({'pad_size': (size, size)})   # the canvas
    plain = DetectorBundle(bundle.cfg, bundle.detector, dtype,
                           device_norm=bundle.device_norm,
                           plain_pair_mask=True)
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (size, size, 3), np.uint8)
              for _ in range(n_images)]
    inference_detector_tta(bundle, images[0])                       # warm
    reset_launches()
    t0 = time.perf_counter()
    got = [inference_detector_tta(bundle, im) for im in images]
    sync(device)
    seconds = time.perf_counter() - t0
    counts = read_launches()
    n_dets = sum(per_class_dets(r, bundle.num_classes, size) for r in got)
    # three requests an image, then one NMS a class with detections
    merges = sum(sum(len(d) > 0 for d in r) for r in got)
    if counts['nms_pair_mask'] != ((3 * n_images + merges) if on_card
                                   else 0):
        raise AssertionError(f'launches {counts} for {n_images} images, '
                             f'{merges} class merges')
    ref = [inference_detector_tta(plain, im) for im in images]
    err, moved, aside = same_detections(
        stack_results(got, bundle.num_classes),
        stack_results(ref, bundle.num_classes), [-1.0] * n_images)
    log(f'[tta] {card} | inference_detector_tta, '
        f'{str(dtype).split(".")[-1]}, {n_images} images of {size}^2 (batch '
        f'1, 3 passes each): {1e3 * seconds / n_images:.1f} ms an image; '
        f'{n_dets} detections; launches {counts}; the plain pair mask gives '
        f'the same detections (max |diff| {err:.3g}, {moved} rows moved)')
    return counts


def zero_class_bias(state_dict) -> dict:
    """Trained weights with the class bias zeroed, so that scores after a
    few steps pass score_thr (as phase 17 does)."""
    weights = dict(state_dict)
    weights['bbox_head.retina_cls.bias'] = torch.zeros_like(
        weights['bbox_head.retina_cls.bias'])
    return weights


def phase_submission(root, state_dict, card='', config=SYNTH1024_CONFIG,
                     n_images=6, size=1024, tile=256, gap=64, device='cuda',
                     batch_size=8, max_objs=18, max_per_img=100) -> tuple:
    """The DOTA huge-image flow of ``tools/data/synth/tiled_eval_demo.py``
    with the port's tools: ``n_images`` ``size``^2 scenes from the port's
    generator, split by ``tools.img_split`` at ``tile`` px with ``gap``,
    single-scale and with rates 0.5 / 1.0 / 2.0; ``batched_eval`` of
    phase 16's trained synth1024 RetinaNet (class bias zeroed, at most
    ``max_per_img`` detections a tile, the tiny-synth configs' cut: with
    every score near 0.5 a tile would keep up to 2000 and a multi-scale
    image's merge would reach 10^5 boxes, far past a trained detector's)
    on the tiles and ``format_results`` (the zip of 15 Task1 files),
    counted; then
    ``merge_det`` with the kernels and with the plain pair mask (the same
    detections) and the original-frame mAP. Returns the counted runs'
    launches and every input ``format_results``'s merge gave the pair-mask
    kernel."""
    import shutil
    import zipfile
    from orientedobjectdetection_torch.apis.eval import (_default_norm,
                                                         batched_eval)
    from orientedobjectdetection_torch.apis.inference import init_detector
    from orientedobjectdetection_torch.core.eval_map import eval_rbbox_map
    from orientedobjectdetection_torch.datasets import build_dataset
    from orientedobjectdetection_torch.ops import nms
    from orientedobjectdetection_torch.tools import img_split
    from orientedobjectdetection_torch.tools.generate_synth import \
        generate_synth
    shutil.rmtree(root, ignore_errors=True)
    big = os.path.join(root, 'big', 'test')
    generate_synth(os.path.join(root, 'big'), n_images, size, seed=7,
                   split='test', max_objs=max_objs)
    cfg = synth_config(config, root)
    weights = zero_class_bias(state_dict)

    def tiles(ann_dir, img_dir):
        return build_dataset(dict(cfg.data['test'], ann_file=ann_dir + '/',
                                  img_prefix=img_dir + '/', test_mode=True,
                                  filter_empty_gt=False))

    orig = tiles(os.path.join(big, 'annfiles'), os.path.join(big, 'images'))
    by_id = {os.path.splitext(i['filename'])[0]: i['ann']
             for i in orig.data_infos}
    counts = collections.Counter()
    merge_inputs = []
    for label, rates in (('single-scale', ['1.0']),
                         ('multi-scale', ['0.5', '1.0', '2.0'])):
        split = os.path.join(root, f'split_{label}')
        t0 = time.perf_counter()
        n_tiles = img_split.main([
            '--img-dirs', os.path.join(big, 'images'), '--ann-dirs',
            os.path.join(big, 'annfiles'), '--save-dir', split, '--sizes',
            str(tile), '--gaps', str(gap), '--rates', *rates])
        split_s = time.perf_counter() - t0
        win = int(tile / min(float(r) for r in rates))
        run_cfg = cfg.copy()
        run_cfg.merge_from_dict({'pad_size': (win, win),
                                 'model.test_cfg.max_per_img': max_per_img})
        bundle = init_detector(run_cfg, weights, device=device,
                               device_norm=_default_norm(run_cfg))
        ds = tiles(os.path.join(split, 'annfiles'),
                   os.path.join(split, 'images'))
        if len(ds) != n_tiles:
            raise AssertionError(f'{len(ds)} tiles in the dataset, '
                                 f'{n_tiles} written')
        sub = os.path.join(root, f'submission_{label}')
        reset_launches()
        t0 = time.perf_counter()
        results = batched_eval(bundle, ds, batch_size=batch_size,
                               progress=False)
        sync(device)
        eval_s = time.perf_counter() - t0
        with recording(nms, 'nms_pair_mask', keep_results=False) as calls:
            t0 = time.perf_counter()
            zip_path = ds.format_results(results, submission_dir=sub,
                                         device=device)
            sync(device)
            format_s = time.perf_counter() - t0
        run = read_launches()
        counts.update(run)
        merge_inputs.extend(pair_mask_inputs(calls))
        with zipfile.ZipFile(zip_path) as zf:
            names = sorted(zf.namelist())
            lines = sum(len(zf.read(n).decode().splitlines()) for n in names)
        want = sorted(f'Task1_{c}.txt' for c in ds.CLASSES)
        if names != want or len(names) != 15:
            raise AssertionError(f'the zip holds {names}')
        t0 = time.perf_counter()
        ids, merged = ds.merge_det(results, device=device)
        sync(device)
        merge_s = time.perf_counter() - t0
        _, merged_plain = ds.merge_det(results, device=device,
                                       plain_pair_mask=True)
        if sorted(ids) != sorted(by_id) or lines != sum(
                len(c) for m in merged for c in m):
            raise AssertionError(f'merged ids {ids}, {lines} Task1 lines')
        err, moved, aside = same_detections(
            stack_results(merged, len(ds.CLASSES)),
            stack_results(merged_plain, len(ds.CLASSES)), [-1.0] * len(ids))
        annotations = [dict(by_id[i], bboxes_ignore=np.zeros((0, 5),
                                                             np.float32),
                            labels_ignore=np.zeros((0,), np.int64))
                       for i in ids]
        mean_ap, _ = eval_rbbox_map(merged, annotations, iou_thr=0.5,
                                    device=device, logger='silent')
        sizes = [b.shape[1] for b, _ in pair_mask_inputs(calls)]
        log(f'[submission] {card} | {label} ({"/".join(rates)}): '
            f'{n_images} scenes of {size}^2 -> {n_tiles} tiles of up to '
            f'{win}^2 in {split_s:.1f} s; batched_eval {eval_s:.2f} s; '
            f'format_results (merge_det + Task1 + zip) {format_s:.2f} s; '
            f'merge_det alone {merge_s:.2f} s for {len(sizes)} NMS calls, '
            f'{1e3 * merge_s / max(len(sizes), 1):.2f} ms a call, N '
            f'{min(sizes, default=0)}-{max(sizes, default=0)}; '
            f'{lines} Task1 lines in 15 files; launches {run}; merge_det '
            f'with the plain pair mask the same (max |diff| {err:.3g}, '
            f'{moved} rows moved); original-frame mAP {mean_ap:.4f} (phase '
            f'16\'s few training steps with the class bias zeroed: not a '
            f'quality number)')
    return dict(counts), {'submission_merge': merge_inputs}


def hrsc_sets(root, n_train, n_val, size) -> None:
    """The port's HRSC layout with ``n_train`` ids in ``trainval.txt`` and
    the next ``n_val`` in ``test.txt``."""
    import shutil
    from orientedobjectdetection_torch.tools.generate_synth import \
        generate_synth_hrsc
    shutil.rmtree(root, ignore_errors=True)
    generate_synth_hrsc(root, n_train + n_val, size, seed=0)
    sets = os.path.join(root, 'ImageSets')
    with open(os.path.join(sets, 'trainval.txt')) as f:
        ids = f.read().split()
    for name, part in (('trainval', ids[:n_train]), ('test', ids[n_train:])):
        with open(os.path.join(sets, f'{name}.txt'), 'w') as f:
            f.write('\n'.join(part) + '\n')


def loader_rate(dataset_cfg, bsz, num_workers, batches, max_gt=512,
                want=None) -> tuple:
    """imgs/s of a DataLoader alone over ``batches`` batches; checks the
    images' (shape, dtype) against ``want``."""
    from orientedobjectdetection_torch.datasets import (DataLoader,
                                                        build_dataset)
    loader = DataLoader(build_dataset(dataset_cfg, seed=0), bsz,
                        max_gt=max_gt, num_workers=num_workers, seed=0)
    seen, shapes = 0, set()
    t0 = time.perf_counter()
    for i, batch in enumerate(loader):
        shapes.add((tuple(batch['images'].shape), batch['images'].dtype))
        seen += bsz
        if i + 1 == batches:
            break
    seconds = time.perf_counter() - t0
    if want is not None and shapes != {want}:
        raise AssertionError(f'batches {shapes}, expected {want}')
    return seen / seconds, shapes


def phase_augment(root, work_dir, card='', config=HRSC_CONFIG, n_train=40,
                  n_val=8, size=1024, steps=20, dtype=torch.bfloat16,
                  device='cuda', log_interval=5, bare_steps=10,
                  mosaic_batches=5) -> tuple:
    """Augmenting training on HRSC: the port's generator writes ``n_train``
    + ``n_val`` BMP scenes of ``size``^2; the HRSC rr config (R50-FPN at
    published widths, ``RResize(800, 512)``, flips, ``PolyRandomRotate``)
    with its ``data_root`` moved there. Its DataLoader alone with and
    without ``PolyRandomRotate``, and a ``MultiImageMixDataset`` with
    ``RMosaic`` for ``mosaic_batches`` batches; ``train_detector`` for
    ``steps`` steps (one IoU-matrix launch a step) with its evaluation, the
    same step alone on a loader batch, and one ``evaluate`` (AP50, AP75)
    with the class bias zeroed. Returns the launches of the training run and
    of that evaluation, and every IoU-matrix input of both."""
    from orientedobjectdetection_torch.apis.eval import (_default_norm,
                                                         batched_eval)
    from orientedobjectdetection_torch.apis.inference import init_detector
    from orientedobjectdetection_torch.apis.train import setup_training
    from orientedobjectdetection_torch.datasets import (build_dataset,
                                                        strip_host_normalize)
    from orientedobjectdetection_torch.ops import iou_kernels
    on_card = torch.device(device).type == 'cuda'
    t0 = time.perf_counter()
    hrsc_sets(root, n_train, n_val, size)
    gen_s = time.perf_counter() - t0
    cfg = synth_config(config, root)
    bsz = int(cfg.data['samples_per_gpu'])
    threads = int(cfg.data['workers_per_gpu']) * 4
    train_cfg, norm = strip_host_normalize(cfg.data['train'])
    if norm is None or not any(t['type'] == 'PolyRandomRotate'
                               for t in train_cfg['pipeline']):
        raise AssertionError('the config has no Normalize or no rotation')
    no_rotation = dict(train_cfg, pipeline=[
        t for t in train_cfg['pipeline'] if t['type'] != 'PolyRandomRotate'])
    from orientedobjectdetection_torch.datasets.pipelines import \
        rescale_size
    resize = [t for t in train_cfg['pipeline'] if t['type'] == 'RResize']
    side = rescale_size((size, size), resize[0]['img_scale'])[0]
    batches = n_train // bsz
    rates = {}
    for label, spec in (('with', train_cfg), ('without', no_rotation)):
        rates[label] = loader_rate(spec, bsz, threads, batches, want=(
            (bsz, side, side, 3), torch.uint8))[0]
    mosaic = dict(type='MultiImageMixDataset', dataset=no_rotation,
                  pipeline=[dict(type='RMosaic', img_scale=(side, side))])
    mosaic_rate = loader_rate(mosaic, bsz, threads, mosaic_batches, want=(
        (bsz, 2 * side, 2 * side, 3), torch.float32))[0]

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with recording(iou_kernels, 'box_iou_rotated_matrix') as matrices:
        state, counts, seconds, log_lines = run_trainer(
            cfg, work_dir, steps, device, dtype, 1, log_interval)
    mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
        else float('nan')
    assign = [args for args, _ in matrices[:steps]]
    if len(assign) != steps or any(a[1].dim() != 2 for a in assign):
        raise AssertionError(f'{len(matrices)} IoU matrices in {steps} '
                             f'steps + eval')
    val_line = [r for r in log_lines if r.get('mode') == 'val'][0]
    loop_rate = float(np.mean([r['imgs_per_sec'] for r in log_lines
                               if 'imgs_per_sec' in r][1:] or [0.0]))
    setup = setup_training(cfg, dtype=dtype, device=device)
    batch = next(iter(setup.loader))
    batch.pop('img_metas')
    bare, step = setup.state, setup.step_fn
    for _ in range(3):
        bare, _ = step(bare, batch)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(bare_steps):
        bare, metrics = step(bare, batch)
    sync(device)
    check_metrics(metrics)
    bare_rate = bsz * bare_steps / (time.perf_counter() - t0)

    val = build_dataset(dict(cfg.data['val'], test_mode=True,
                             filter_empty_gt=False))
    weights = zero_class_bias(state.model.state_dict())
    bundle = init_detector(cfg, weights, device=device,
                           device_norm=_default_norm(cfg))
    reset_launches()
    with recording(iou_kernels, 'box_iou_rotated_matrix') as evals:
        results = batched_eval(bundle, val, batch_size=8, progress=False)
        ev = val.evaluate(results, device=device)
    sync(device)
    eval_counts = read_launches()
    if sorted(ev) != ['AP50', 'AP75', 'mAP'] or \
            not all(0 <= v <= 1 for v in ev.values()):
        raise AssertionError(f'evaluate gave {ev}')
    if on_card and eval_counts['box_iou_rotated'] != 2:
        raise AssertionError(f'evaluate launches {eval_counts}')
    losses = [r['loss'] for r in log_lines if 'loss' in r]
    log(f'[augment] {card} | HRSC rr (R{cfg.model["backbone"]["depth"]}-FPN,'
        f' {os.path.basename(config)}) '
        f'on {n_train} + {n_val} BMP scenes of {size}^2 generated in '
        f'{gen_s:.1f} s; DataLoader alone (batch {bsz} of {side}^2 uint8, '
        f'{threads} threads): {rates["with"]:.2f} imgs/s with '
        f'PolyRandomRotate, {rates["without"]:.2f} without; '
        f'MultiImageMixDataset + RMosaic ({2 * side}^2 float32): '
        f'{mosaic_rate:.2f} imgs/s over {mosaic_batches} batches; '
        f'train_detector {str(dtype).split(".")[-1]}, {steps} steps + eval: '
        f'{seconds:.1f} s, loop {loop_rate:.2f} imgs/s against '
        f'{bare_rate:.2f} for the same step alone on a loader batch; loss '
        f'{losses[0]:.4f} -> {losses[-1]:.4f}; peak memory {mem:.2f} GiB; '
        f'launches {counts} (val AP50 {val_line["AP50"]:.4f}); evaluate '
        f'with the class bias zeroed: AP50 {ev["AP50"]:.4f}, AP75 '
        f'{ev["AP75"]:.4f}, launches {eval_counts}')
    merged = collections.Counter(counts)
    merged.update(eval_counts)
    return dict(merged), {'hrsc_assign': assign,
                          'hrsc_train_eval_iou': [a for a, _ in
                                                  matrices[steps:]],
                          'hrsc_eval_iou': [a for a, _ in evals]}


# ---- 23.-26. the other single-stage families -------------------------------
FCOS_CONFIG = os.path.join(ROOT, 'configs', 'rotated_fcos',
                           'rotated_fcos_r50_fpn_1x_dota_le90.py')
# the anchor recipes of phase 25, each at its published R50 config (KLD
# twice: GDLoss_v1, and the stable GDLoss)
FAMILY_CONFIGS = {
    'atss': os.path.join(ROOT, 'configs', 'rotated_atss',
                         'rotated_atss_obb_r50_fpn_1x_dota_le90.py'),
    'kfiou': os.path.join(ROOT, 'configs', 'kfiou',
                          'rotated_retinanet_obb_kfiou_r50_fpn_1x_dota_le90'
                          '.py'),
    'gwd': os.path.join(ROOT, 'configs', 'gwd',
                        'rotated_retinanet_obb_gwd_r50_fpn_1x_dota_le90.py'),
    'kld': os.path.join(ROOT, 'configs', 'kld',
                        'rotated_retinanet_obb_kld_r50_fpn_1x_dota_le90.py'),
    'kld_stable': os.path.join(
        ROOT, 'configs', 'kld',
        'rotated_retinanet_obb_kld_stable_r50_fpn_1x_dota_le90.py'),
    'csl': os.path.join(
        ROOT, 'configs', 'csl',
        'rotated_retinanet_obb_csl_gaussian_r50_fpn_fp16_1x_dota_le90.py'),
}
FAMILY_TINY_CONFIGS = {
    'fcos': os.path.join(ROOT, 'configs', 'rotated_fcos',
                         'rotated_fcos_tiny_synth.py'),
    'csl': os.path.join(ROOT, 'configs', 'csl', 'csl_tiny_synth.py'),
}
# ATSS, kernel vs plain matrix: an assignment may differ where a candidate's
# IoU lies this close to its gt's threshold (the mean + std of IoUs that
# differ by up to IOU_ATOL), or two gts claim a prior with IoUs this close
ATSS_BAND = 1e-4
# phase 26's evaluation score threshold (the configs': 0.05)
EVAL_SCORE_THR = 1e-3


def nms_cut(bundle, outputs) -> torch.Tensor:
    """Per image, the lowest score entering NMS: the ``max_candidates``-th
    of the (candidate, class) scores (times the centerness for FCOS)."""
    head = bundle.detector.bbox_head
    with torch.inference_mode():
        cand = head.candidates(outputs)
    scores = cand[1] if len(cand) == 2 else cand[1] * cand[2][..., None]
    scores = scores.flatten(1)
    k = min(int(head.test_cfg.get('max_candidates', 2000)), scores.shape[1])
    return scores.topk(k)[0][:, -1]


def phase_family_slice(config, label, device, bsz=2, size=1024,
                       max_candidates=2000) -> None:
    """float32: the same outputs decoded with the pair-mask kernel and with
    its plain version give the same detections (:func:`same_detections`)."""
    from orientedobjectdetection_torch.apis import DetectorBundle
    bundle = build_bundle(device, torch.float32, max_candidates,
                          config=config)
    plain = DetectorBundle(bundle.cfg, bundle.detector, torch.float32,
                           device_norm=bundle.device_norm,
                           plain_pair_mask=True)
    outputs = bundle.forward(raw_images(bsz, size, 70))
    got = bundle.decode(outputs)
    sync(device)
    check_dets(*got, bsz, bundle.num_classes)
    err, moved, aside = same_detections(got, plain.decode(outputs),
                                        nms_cut(bundle, outputs))
    log(f'[{label}-slice] float32 B={bsz} {size}^2: kernel and plain pair '
        f'mask give the same detections (max |diff| {err:.3g}; {moved} rows '
        f'within {SCORE_BAND} in score in another place, {aside} set aside '
        f'at the NMS cut); valid dets per image {got[2].sum(1).tolist()}')


def phase_family_serving(config, label, device, card='', bsz=8, size=1024,
                         warm=3, timed=10, dtype=torch.bfloat16,
                         max_candidates=2000) -> tuple:
    """Requests of ``bsz`` raw images through the bundle: imgs/s, the split
    between forward and decode + NMS, peak memory, one pair-mask launch a
    request. Returns the launch counts and one more request's NMS inputs
    (boxes, class ids)."""
    on_card = torch.device(device).type == 'cuda'
    bundle = build_bundle(device, dtype, max_candidates, config=config)
    images = raw_images(bsz, size, 80)
    if on_card:
        images = images.pin_memory()
    fwd, dec, outputs, (dets, labels, valid), counts = timed_requests(
        bundle, images, warm, timed, device)
    launches = counts['nms_pair_mask']
    if launches != (warm + timed if on_card else 0):
        raise AssertionError(f'{label}: nms_pair_mask launched {launches} '
                             f'times for {warm + timed} requests')
    check_dets(dets, labels, valid, bsz, bundle.num_classes)
    mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
        else float('nan')
    log(f'[{label}-serving] {card} | {str(dtype).split(".")[-1]} B={bsz} '
        f'{size}^2, {timed} timed requests after {warm} warm: '
        f'{bsz * timed / (fwd + dec):.2f} imgs/s; per request forward '
        f'{1e3 * fwd / timed:.2f} ms, decode+NMS {1e3 * dec / timed:.2f} ms; '
        f'peak memory {mem:.2f} GiB; nms_pair_mask launches {launches}; '
        f'valid dets per image {valid.sum(1).tolist()}')
    from orientedobjectdetection_torch.ops import nms
    with recording(nms, 'nms_pair_mask') as calls:
        bundle(images)
    boxes, _, cls = calls[0][0]
    return counts, (boxes, cls)


def head_anchors(head, size, device) -> tuple:
    """The head's anchors for a ``size`` x ``size`` image and their count
    per level."""
    sizes = [(-(-size // s[1]), -(-size // s[0]))
             for s in head.prior_generator.strides]
    levels = head.anchors(sizes, device)
    return torch.cat(list(levels), 0), [len(lv) for lv in levels]


def check_atss_assigner(assigner, priors, num_level, gts, labels,
                        mask) -> tuple:
    """ATSS with the kernel and with the plain matrix: equal except where a
    candidate's IoU lies within ATSS_BAND of its gt's threshold or two
    claims on a prior are that close. Returns (positives, differing
    priors)."""
    was = assigner.plain_iou
    try:
        assigner.plain_iou = False
        got = assigner(priors, num_level, gts, labels, mask)
        assigner.plain_iou = True
        ref = assigner(priors, num_level, gts, labels, mask)
        overlaps, is_cand, thr, inside = assigner.statistics(
            priors, num_level, gts, mask)
    finally:
        assigner.plain_iou = was
    differ = got.assigned_gt_inds != ref.assigned_gt_inds
    near = (is_cand & inside & ((overlaps - thr).abs() < ATSS_BAND)).any(2)
    pos = is_cand & inside & (overlaps >= thr - ATSS_BAND) & \
        mask[:, None, :]
    top2 = torch.where(pos, overlaps, -1.0).topk(2, dim=2)[0]
    tie = (top2[..., 1] > -1) & (top2[..., 0] - top2[..., 1] < ATSS_BAND)
    outside = int((differ & ~(near | tie)).sum())
    if outside:
        raise AssertionError(f'{outside} ATSS assignments differ between '
                             f'kernel and plain outside the band')
    if float((got.max_overlaps - ref.max_overlaps).abs().max()) > IOU_ATOL:
        raise AssertionError('max_overlaps differ between kernel and plain')
    return int((got.assigned_gt_inds >= 0).sum()), int(differ.sum())


def family_step(config, device, batch, plain_iou) -> dict:
    """A fresh seeded float32 trainer on ``config`` takes one step on
    ``batch``: its metrics, the parameters before and after."""
    detector, state, step = build_trainer(device, torch.float32,
                                          plain_iou=plain_iou, config=config)
    before = {n: p.detach().clone() for n, p in detector.named_parameters()}
    state, metrics = step(state, batch)
    sync(device)
    check_metrics(metrics)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                before=before, detector=detector,
                adam=isinstance(state.optimizer, torch.optim.AdamW),
                grads={n: p.grad.detach().clone()
                       for n, p in detector.named_parameters()
                       if p.grad is not None},
                after={n: p.detach().clone()
                       for n, p in detector.named_parameters()})


def same_params(got, ref, label) -> float:
    """Two steps from one state: losses within LOSS_RTOL, parameters within
    PARAM_RTOL of each tensor's change or one float32 step of their value
    (a tensor whose change is a few of its own steps, as a neck conv's with
    a tiny gradient is, may round to the next float32 in one update and
    not in the other), frozen tensors unchanged. After an AdamW step, the
    elements whose gradient is under ADAM_FIRM of their tensor's largest
    are held to that tensor's change instead. Returns the largest
    difference beyond a float32 step relative to its tensor's change."""
    for k, v in ref['metrics'].items():
        if k != 'grad_norm' and abs(got['metrics'][k] - v) > \
                LOSS_RTOL * abs(v):
            raise AssertionError(f'{label}: {k} {got["metrics"][k]} vs {v}')
    worst = 0.0
    for n, before in ref['before'].items():
        moved = ref['after'][n] - before
        err = float((got['after'][n] - ref['after'][n]).abs().max())
        if not ref['detector'].get_parameter(n).requires_grad:
            if moved.any() or err:
                raise AssertionError(f'{label}: {n}: frozen tensor changed')
            continue
        scale = float(moved.abs().max())
        after = ref['after'][n].abs()
        step = torch.nextafter(after, torch.full_like(after, float('inf'))) \
            - after
        diff = (got['after'][n] - ref['after'][n]).abs()
        beyond = torch.where(diff > step, diff, 0.0)
        if ref.get('adam'):
            grad = ref['grads'][n].abs()
            loose = grad < ADAM_FIRM * grad.max()
            if float(torch.where(loose, beyond, 0.0).max()) > scale:
                raise AssertionError(f'{label}: {n} after the AdamW step '
                                     f'differs by more than its change')
            beyond = torch.where(loose, 0.0, beyond)
        beyond = float(beyond.max())
        worst = max(worst, beyond / scale) if scale else worst
        if beyond > PARAM_RTOL * scale:
            raise AssertionError(f'{label}: {n} after the step differs by '
                                 f'{err} > {PARAM_RTOL} x {scale} and more '
                                 f'than a float32 step of its value')
    return worst


def phase_family_train_slice(config, label, device, bsz=2, size=1024, g=32,
                             valid=8) -> None:
    """float32: the head's assigner with the IoU-matrix kernel and with the
    plain matrix assigns alike (:func:`check_assigner`, or
    :func:`check_atss_assigner` for ATSS); one step from one seeded state
    with each gives the same losses and parameters (:func:`same_params`)."""
    batch = train_batch(bsz, size, g, valid, 90, device)
    kernel = family_step(config, device, batch, False)
    head = kernel['detector'].bbox_head
    priors, num_level = head_anchors(head, size, device)
    gts, labels, mask = (batch[k].to(device) for k in
                         ('gt_bboxes', 'gt_labels', 'gt_mask'))
    if hasattr(head.assigner, 'statistics'):
        positives, differ = check_atss_assigner(
            head.assigner, priors, num_level, gts.float(), labels, mask)
    else:
        positives, differ = check_assigner(head.assigner, priors,
                                           gts.float(), labels, mask)
    if positives < 1:
        raise AssertionError(f'{label}: the batch has no positive anchor')
    plain = family_step(config, device, batch, True)
    worst = same_params(kernel, plain, label)
    log(f'[{label}-train-slice] float32 B={bsz} {size}^2, G={g} ({valid} '
        f'valid): {positives} positive anchors, {differ} assignments differ '
        f'(all in the band); losses {kernel["metrics"]} equal to the plain '
        f'matrix\'s within {LOSS_RTOL}; parameters within {worst:.3g} of '
        f'each tensor\'s change (<= {PARAM_RTOL}, or a float32 step of '
        f'the value)')


def phase_family_training(config, label, device, card='', bsz=8, size=1024,
                          g=32, valid=8, warm=3, timed=10,
                          dtype=torch.bfloat16, profile=False, padded_g=0,
                          padded_valid=64, falling=False, rng=None,
                          norm_eval=True) -> tuple:
    """``warm + timed`` steps on one fixed batch: imgs/s, peak memory, one
    IoU-matrix launch a step for each assigner (FCOS has none, a refine
    detector one a stage), finite losses. ``profile``: one more step split
    by the ``train.*`` and the heads' ``fcos.*`` and ``csl.*`` ranges and
    the refine detectors' ``refine.*``. ``padded_g``: one more step at the
    loader's padding (``padded_g`` gts, ``padded_valid`` of them valid), for
    its peak memory. ``falling``: the loss of the last step must be below
    the first's (on the fixed batch). ``rng``: a two-stage detector's
    sampling key for every step (the same RoIs each step; by default the
    step's own). ``norm_eval=False``: live BatchNorm. Returns dict(counts,
    rate (imgs/s),
    inputs: one more
    step's IoU-matrix inputs, padded_inputs: those of the padded step (both
    None without an assigner), detector, step_once: a function that takes
    one more step, step_on: one that takes a step on another batch)."""
    on_card = torch.device(device).type == 'cuda'
    detector, state, step = build_trainer(device, dtype, config=config,
                                          norm_eval=norm_eval)
    batch = train_batch(bsz, size, g, valid, 100, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    history = []
    for i in range(warm + timed):
        if i == warm:
            sync(device)
            t0 = time.perf_counter()
        state, metrics = step(state, batch, rng)
        history.append(metrics)
    sync(device)
    seconds = time.perf_counter() - t0
    counts = read_launches()
    per_step = len(assigners(detector))
    launches = counts['box_iou_rotated']
    if launches != (per_step * (warm + timed) if on_card else 0):
        raise AssertionError(f'{label}: box_iou_rotated launched {launches} '
                             f'times in {warm + timed} steps')
    for metrics in history:
        check_metrics(metrics)
    if falling and not float(history[-1]['loss']) < float(history[0]['loss']):
        raise AssertionError(f'{label}: the loss did not fall on the fixed '
                             f'batch: {[float(m["loss"]) for m in history]}')
    mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
        else float('nan')
    terms = {k: f'{float(history[0][k]):.4f} -> {float(history[-1][k]):.4f}'
             for k in history[0] if 'loss' in k}
    log(f'[{label}-training] {card} | {str(dtype).split(".")[-1]} B={bsz} '
        f'{size}^2, G={g} ({valid} valid), {timed} timed steps after {warm} '
        f'warm: {bsz * timed / seconds:.2f} imgs/s, '
        f'{1e3 * seconds / timed:.2f} ms per step; peak memory {mem:.2f} '
        f'GiB; box_iou_rotated launches {launches}; {terms}')
    from orientedobjectdetection_torch.ops import iou_kernels
    inputs = padded_inputs = None
    if padded_g:
        padded = train_batch(bsz, size, padded_g, padded_valid, 110, device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        with recording(iou_kernels, 'box_iou_rotated_matrix') as calls:
            state, metrics = step(state, padded, rng)
        sync(device)
        check_metrics(metrics)
        padded_inputs = [args for args, _ in calls] if per_step else None
        mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
            else float('nan')
        log(f'[{label}-training] one step at the loader\'s padding, '
            f'G={padded_g} ({padded_valid} valid): peak memory {mem:.2f} '
            f'GiB')
    if per_step:
        with recording(iou_kernels, 'box_iou_rotated_matrix') as calls:
            state, _ = step(state, batch, rng)
        inputs = [args for args, _ in calls]
    if profile:
        prof = profile_run(lambda: step(state, batch, rng), device,
                           f'{label} train step',
                           ('train.', 'fcos.', 'csl.', 'refine.'))
        if prof['busy_us']:
            spans = prof['spans']
            named = sum(spans.get(k, 0) for k in
                        ('train.forward', 'train.loss', 'train.update'))
            heads = ', '.join(f'{k} {v / 1e3:.2f}' for k, v in spans.items()
                              if not k.startswith('train.'))
            log(f'[profile] device time: forward '
                f'{spans.get("train.forward", 0) / 1e3:.2f} ms, targets + '
                f'loss {spans.get("train.loss", 0) / 1e3:.2f} ms ({heads}), '
                f'optimizer {spans.get("train.update", 0) / 1e3:.2f} ms, '
                f'backward (the rest) '
                f'{(prof["busy_us"] - named) / 1e3:.2f} ms')
    return dict(counts=counts, rate=bsz * timed / seconds, inputs=inputs,
                padded_inputs=padded_inputs, detector=detector,
                step_once=lambda: step(state, batch, rng),
                step_on=lambda other: step(state, other, rng))


def phase_fcos(device, card='', bsz=8, size=1024, slice_bsz=2, warm=3,
               timed=10, train_warm=3, train_timed=10, g=32, valid=8,
               max_candidates=2000, dtype=torch.bfloat16, padded_g=512,
               padded_valid=64) -> tuple:
    """Phases 23 and 24: Rotated FCOS served (a float32 slice, then
    ``dtype`` requests) and trained (and one step at the loader's padding
    for its peak memory: the point targets are (B, N, G)). Returns the
    runs' launch counts and one request's NMS inputs under ``'fcos'``."""
    phase_family_slice(FCOS_CONFIG, 'fcos', device, slice_bsz, size,
                       max_candidates)
    serving, nms_inputs = phase_family_serving(
        FCOS_CONFIG, 'fcos', device, card, bsz, size, warm, timed, dtype,
        max_candidates)
    training = phase_family_training(
        FCOS_CONFIG, 'fcos', device, card, bsz, size, g, valid, train_warm,
        train_timed, dtype, profile=True, padded_g=padded_g,
        padded_valid=padded_valid)['counts']
    return [serving, training], {'fcos': nms_inputs}


def phase_anchor_families(device, card='', bsz=8, size=1024, slice_bsz=2,
                          warm=2, timed=5, serve_warm=3, serve_timed=10,
                          g=32, valid=8, max_candidates=2000,
                          dtype=torch.bfloat16,
                          families=tuple(FAMILY_CONFIGS), padded_g=512,
                          padded_valid=64) -> tuple:
    """Phase 25: each anchor recipe's float32 train slice and ``dtype``
    training (ATSS also one step at the loader's padding for its peak
    memory: its tensors are (B, N, G); CSL one profiled step, its angle
    loss in a range of its own), then its float32 serving slice and
    ``dtype`` requests. Returns the runs' launch counts, and the ATSS and
    KFIoU steps' assigner inputs and one CSL request's NMS inputs."""
    runs, captured = [], {}
    for label in families:
        config = FAMILY_CONFIGS[label]
        phase_family_train_slice(config, label, device, slice_bsz, size, g,
                                 valid)
        run = phase_family_training(
            config, label, device, card, bsz, size, g, valid, warm, timed,
            dtype, profile=label == 'csl',
            padded_g=padded_g if label == 'atss' else 0,
            padded_valid=padded_valid)
        counts = run['counts']
        captured[f'{label}_train'] = run['inputs'][0]
        phase_family_slice(config, label, device, slice_bsz, size,
                           max_candidates)
        serving, captured[label] = phase_family_serving(
            config, label, device, card, bsz, size, serve_warm, serve_timed,
            dtype, max_candidates)
        runs += [counts, serving]
    return runs, captured


def phase_family_loops(root, work_root, card='', configs=None, steps=20,
                       dtype=torch.bfloat16, device='cuda',
                       log_interval=5, per_step=None) -> tuple:
    """Phase 26: the FCOS and CSL tiny-synth configs through
    ``train_detector`` on phase 18's set, ``steps`` steps and the
    evaluation (B1 in its NMS, B2 in its IoUs and in CSL's assigner). The
    evaluation keeps scores from ``EVAL_SCORE_THR`` on: after 20 steps the
    focal prior still holds most scores under the configs' 0.05, and
    ``eval_rbbox_map`` computes no IoU without a detection. ``per_step``:
    label -> the IoU-matrix launches of a step (by default none for FCOS,
    one for the others). Returns the runs' launch counts and every input
    they gave the kernels (a two-stage detector's evaluation RoIAlign
    inputs too: levels, RoIs, sampling ratio)."""
    from orientedobjectdetection_torch.models.roi_heads import (
        oriented_roi_head)
    from orientedobjectdetection_torch.ops import iou_kernels, nms
    configs = configs or FAMILY_TINY_CONFIGS
    runs, inputs = [], {}
    for label, config in configs.items():
        cfg = synth_config(config, root)
        cfg.merge_from_dict({'model.test_cfg.score_thr': EVAL_SCORE_THR})
        launches = (per_step or {}).get(label, int(label != 'fcos'))
        with recording(iou_kernels, 'box_iou_rotated_matrix') as matrices, \
                recording(nms, 'nms_pair_mask') as masks, \
                recording(oriented_roi_head, 'roi_align_rotated_pyramid',
                          keep_results=False) as pools:
            _, counts, seconds, log_lines = run_trainer(
                cfg, os.path.join(work_root, label), steps, device, dtype,
                launches, log_interval)
        train = matrices[:launches * steps]
        if not masks or len(matrices) <= len(train) or len(train) != \
                launches * steps:
            raise AssertionError(f'{label}: recorded {len(matrices)} IoU '
                                 f'matrices and {len(masks)} pair masks')
        inputs[f'{label}_loop_assign'] = [args for args, _ in train]
        inputs[f'{label}_loop_eval_iou'] = [
            args for args, _ in matrices[len(train):]]
        inputs[f'{label}_loop_nms'] = [(args[0], args[2])
                                       for args, _ in masks]
        inputs[f'{label}_loop_roi_align'] = [(args[0], args[1], args[4])
                                             for args, _ in pools]
        runs.append(counts)
        val = [r for r in log_lines if r.get('mode') == 'val'][0]
        losses = [r['loss'] for r in log_lines if 'loss' in r]
        log(f'[{label}-loop] {card} | train_detector, '
            f'{os.path.basename(config)}, {str(dtype).split(".")[-1]}, '
            f'{steps} steps + eval: {seconds:.1f} s; loss {losses[0]:.4f} '
            f'-> {losses[-1]:.4f}; val mAP {val["mAP"]:.4f}; launches '
            f'{counts}')
    return runs, inputs


def held_families(device, captured, by_name, card, reps, plain_reps) -> None:
    """Phases 23-26's recorded inputs against their plain versions, the
    largest of each kind timed into ``main_path_inputs``: B1 on one FCOS
    and one CSL request's candidates and on the tiny loops' evaluations, B2
    on one ATSS and one KFIoU (MaxIoU) train step's assigner inputs, and on
    the tiny loops' assigner and evaluation matrices."""
    pair, iou = by_name['nms_pair_mask'], by_name['box_iou_rotated']
    for key, label in (('fcos', 'Rotated FCOS request'),
                       ('csl', 'CSL RetinaNet request')):
        boxes, cls = captured[key]
        err, in_band = check_pair_mask(boxes, cls)
        pair['max_abs_err'] = max(pair['max_abs_err'], err)
        log(f'[main-path] nms_pair_mask on the candidates of one {label} '
            f'B={boxes.shape[0]} N={boxes.shape[1]}: equal to plain outside '
            f'+-{BAND} of thr={IOU_THR} ({in_band} in-band differences)')
        pair['main_path_inputs'][key] = time_pair_mask(
            boxes, cls, device, card, f'{label} candidates', reps,
            plain_reps)
    for key, label in (('atss_train', 'ATSS assigner'),
                       ('kfiou_train', 'KFIoU (MaxIoU) assigner')):
        boxes1, boxes2, mode = captured[key]
        err, live = check_iou_matrix(boxes1, boxes2, mode)
        iou['max_abs_err'] = max(iou['max_abs_err'], err)
        log(f'[main-path] box_iou_rotated on the {label}\'s inputs in one '
            f'train step {tuple(boxes1.shape)} x {tuple(boxes2.shape)} '
            f'{mode}: max |kernel - plain| {err:.3g} <= {IOU_ATOL}; {live} '
            f'pairs within reach, the rest exactly 0')
        iou['main_path_inputs'][key] = time_iou_matrix(
            boxes1, boxes2, live, device, card, f'{label} inputs', reps,
            plain_reps, mode)
    for key, label in (('csl_loop_assign', 'tiny CSL loop\'s assigner'),
                       ('fcos_loop_eval_iou', 'tiny FCOS loop\'s evaluation'),
                       ('csl_loop_eval_iou', 'tiny CSL loop\'s evaluation')):
        held_iou_matrices(captured[key], label, key, iou, device, card, reps,
                          plain_reps)
    for key, label in (('fcos_loop_nms', 'tiny FCOS loop\'s evaluation'),
                       ('csl_loop_nms', 'tiny CSL loop\'s evaluation')):
        held_pair_masks(captured[key], label, key, pair, device, card, reps,
                        plain_reps)


# ---- 27.-30. the refine detectors -----------------------------------------
REFINE_CONFIGS = {
    's2anet': os.path.join(ROOT, 'configs', 's2anet',
                           's2anet_r50_fpn_1x_dota_le135.py'),
    'r3det': os.path.join(ROOT, 'configs', 'r3det',
                          'r3det_r50_fpn_1x_dota_oc.py'),
}
# phase 27's other float32 steps: the KFIoU refine recipes and the cascade
REFINE_RECIPES = {
    's2anet_kfiou': os.path.join(ROOT, 'configs', 'kfiou',
                                 's2anet_kfiou_ln_r50_fpn_1x_dota_le135.py'),
    'r3det_kfiou': os.path.join(ROOT, 'configs', 'kfiou',
                                'r3det_kfiou_ln_r50_fpn_1x_dota_oc.py'),
    'r3det_refine': os.path.join(ROOT, 'configs', 'r3det',
                                 'r3det_refine_r50_fpn_1x_dota_oc.py'),
}
REFINE_TINY_CONFIGS = {
    's2anet': os.path.join(ROOT, 'configs', 's2anet',
                           's2anet_tiny_synth.py'),
    'r3det': os.path.join(ROOT, 'configs', 'r3det', 'r3det_tiny_synth.py'),
}
# the refine detectors' record_function ranges, serving and training
REFINE_RANGES = ('refine.first_stage', 'refine.rois', 'refine.align',
                 'refine.head', 'refine.decode_nms')
REFINE_TRAIN_RANGES = REFINE_RANGES[:4] + ('refine.first_loss',
                                           'refine.refine_loss')


def seed_refine_detections(detector) -> None:
    """Seeded refine weights made to give real boxes: the last stage's class
    bias zeroed (scores near 0.5) and every stage's regression scaled down
    (rois near their anchors and boxes near their rois, where they overlap
    as a trained detector's do)."""
    with torch.no_grad():
        for head in detector.heads():
            reg = head.odm_reg if hasattr(head, 'odm_reg') else \
                head.retina_reg
            reg.weight.mul_(0.05)
        last = detector.heads()[-1]
        (last.odm_cls if hasattr(last, 'odm_cls') else
         last.retina_cls).bias.zero_()


def build_refine_bundle(config, device, dtype, max_candidates=2000,
                        seed=0):
    """:func:`build_bundle` for a refine detector: its ``test_cfg`` decides
    the last stage's decode (:func:`seed_refine_detections`)."""
    from orientedobjectdetection_torch.apis import init_detector
    from orientedobjectdetection_torch.utils import Config
    cfg = Config.fromfile(config)
    bundle = init_detector(cfg, device=device, dtype=dtype, seed=seed,
                           device_norm=cfg.img_norm_cfg)
    bundle.detector.test_cfg['max_candidates'] = max_candidates
    seed_refine_detections(bundle.detector)
    return bundle


def refine_nms_cut(bundle, outputs) -> torch.Tensor:
    """Per image, the lowest score entering NMS: the ``max_candidates``-th
    (candidate, class) score of the last stage's top ``nms_pre``
    locations."""
    from orientedobjectdetection_torch.models.dense_heads import \
        rotated_anchor_head
    detector = bundle.detector
    head, outs, _ = detector.last_stage(outputs)
    cfg = detector.test_cfg
    logits = rotated_anchor_head.flatten_levels(outs[0],
                                                head.cls_out_channels)
    k = min(int(cfg.get('nms_pre', 2000)), logits.shape[1])
    top = logits.amax(-1).topk(k, dim=1)[1]
    scores = torch.sigmoid(logits.gather(1, top[..., None].expand(
        -1, -1, logits.shape[-1]))).flatten(1)
    n = min(int(cfg.get('max_candidates', 2000)), scores.shape[1])
    return scores.topk(n)[0][:, -1]


def phase_refine_serving_slice(config, label, device, bsz=2, size=1024,
                               max_candidates=2000) -> list:
    """float32: the same outputs decoded with the pair-mask kernel and with
    its plain version give the same detections (:func:`same_detections`).
    Returns the request's pair-mask inputs (boxes, class ids)."""
    from orientedobjectdetection_torch.apis import DetectorBundle
    from orientedobjectdetection_torch.ops import nms
    bundle = build_refine_bundle(config, device, torch.float32,
                                 max_candidates)
    plain = DetectorBundle(bundle.cfg, bundle.detector, torch.float32,
                           device_norm=bundle.device_norm,
                           plain_pair_mask=True)
    outputs = bundle.forward(raw_images(bsz, size, 120))
    with recording(nms, 'nms_pair_mask') as calls:
        got = bundle.decode(outputs)
    sync(device)
    check_dets(*got, bsz, bundle.num_classes)
    err, moved, aside = same_detections(got, plain.decode(outputs),
                                        refine_nms_cut(bundle, outputs))
    log(f'[{label}-slice] float32 B={bsz} {size}^2: kernel and plain pair '
        f'mask give the same detections (max |diff| {err:.3g}; {moved} rows '
        f'within {SCORE_BAND} in score in another place, {aside} set aside '
        f'at the NMS cut); valid dets per image {got[2].sum(1).tolist()}')
    return [(args[0], args[2]) for args, _ in calls]


def refine_anchors(size, device) -> list:
    """The refine detectors' first-stage anchors for a ``size`` x ``size``
    image: S2ANet's FAM (a 4-stride square a location, 21,824 at 1024^2)
    and R3Det's stage 0 (9 a location, 196,416)."""
    from orientedobjectdetection_torch import core  # noqa: F401 (registers)
    from orientedobjectdetection_torch.utils import Config
    from orientedobjectdetection_torch.utils.registry import PRIOR_GENERATORS
    out = []
    for config, head in ((REFINE_CONFIGS['s2anet'], 'fam_head'),
                         (REFINE_CONFIGS['r3det'], 'bbox_head')):
        gen = PRIOR_GENERATORS.build(dict(
            Config.fromfile(config).model[head]['anchor_generator']))
        sizes = [(-(-size // s[1]), -(-size // s[0])) for s in gen.strides]
        out.append(torch.cat(gen.grid_priors(sizes, device=device), 0))
    return out


def well_posed_batch(bsz, size, g, valid, seed, device, margin=1e-4,
                     thresholds=(0.4, 0.5), anchor_sets=None,
                     view=None) -> dict:
    """:func:`train_batch` with gts drawn so that the MaxIoU assignment on
    each set of ``anchor_sets`` (by default each refine detector's
    first-stage anchors) is decided by more than ``margin``: each gt's
    best anchor leads its next, no anchor's best IoU lies that close to a
    threshold, and no two gts come that close on an anchor. ``view`` maps
    the gts to the boxes the assigner compares (a horizontal RPN's
    ``obb2hbb``). Square anchors inside a gt, or crossed by it, tie in
    exact arithmetic, so that the kernel's rounding and the plain
    version's pick other anchors there, and the losses of a kernel step
    and a plain step part by percents: their comparison needs a decided
    assignment."""
    from orientedobjectdetection_torch.ops.iou_kernels import (
        box_iou_rotated_matrix_plain)
    if anchor_sets is None:
        anchor_sets = refine_anchors(size, device)
    cands, cand_labels, _ = seeded_gts(config_anchors(size, 'cpu'), bsz,
                                       8 * valid, 8 * valid, seed)
    seen = cands if view is None else view(cands)
    gts = torch.zeros((bsz, g, 5))
    labels = torch.zeros((bsz, g), dtype=cand_labels.dtype)
    for b in range(bsz):
        ious = [box_iou_rotated_matrix_plain(seen[b].to(device), a)
                for a in anchor_sets]
        best = [torch.zeros(len(a), device=device) for a in anchor_sets]
        keep = []
        for i in range(cands.shape[1]):
            rows = [iou[i] for iou in ious]
            ok = all(
                float(row.topk(2)[0].diff().abs()) > margin and
                not ((row - run).abs() <= margin)[(row > 0) &
                                                  (run > 0)].any() and
                not any(((row - t).abs() <= margin)[row > run].any()
                        for t in thresholds)
                for row, run in zip(rows, best))
            if ok:
                keep.append(i)
                best = [torch.maximum(run, row) for row, run in
                        zip(rows, best)]
            if len(keep) == valid:
                break
        if len(keep) < valid:
            raise AssertionError(f'image {b}: {len(keep)} of {valid} gts '
                                 f'with a decided assignment')
        gts[b, :valid] = cands[b, keep]
        labels[b, :valid] = cand_labels[b, keep]
    batch = dict(images=raw_images(bsz, size, seed + 1), gt_bboxes=gts,
                 gt_labels=labels,
                 gt_mask=torch.arange(g)[None].expand(bsz, g) < valid)
    if torch.device(device).type == 'cuda':
        batch = {k: v.pin_memory() for k, v in batch.items()}
    return batch


def refine_rois(detector, batch, norm, device) -> list:
    """The rois each refine stage of ``detector`` ran on for ``batch``'s
    images (float32 forward, no gradient)."""
    from orientedobjectdetection_torch.parallel.train_state import \
        normalize_images
    images = normalize_images(batch['images'].to(device), norm)
    with torch.no_grad():
        out = detector(images.permute(0, 3, 1, 2))
    return [out['rois']] if 'rois' in out else out['stage_rois']


def phase_refine_train_slice(config, label, device, bsz=2, size=1024, g=32,
                             valid=8) -> list:
    """float32: one step from one seeded state with the IoU-matrix kernel
    and one with the plain matrix. Each stage's assigner assigns alike with
    both (:func:`check_assigner`: the first stage on its anchors, each
    refine stage on the rois it got); the losses agree within LOSS_RTOL,
    the parameters as :func:`same_params` says. Returns the kernel step's
    IoU-matrix inputs. The gts are :func:`well_posed_batch`'s."""
    from orientedobjectdetection_torch.ops import iou_kernels
    from orientedobjectdetection_torch.utils import Config
    batch = well_posed_batch(bsz, size, g, valid, 130, device)
    with recording(iou_kernels, 'box_iou_rotated_matrix') as calls:
        kernel = family_step(config, device, batch, False)
    detector = kernel['detector']
    with torch.no_grad():
        for n, p in detector.named_parameters():
            p.copy_(kernel['before'][n])
    gts, labels, mask = (batch[k].to(device) for k in
                         ('gt_bboxes', 'gt_labels', 'gt_mask'))
    first, *refine = detector.heads()
    priors = [head_anchors(first, size, device)[0]] + refine_rois(
        detector, batch, Config.fromfile(config).img_norm_cfg, device)
    checked = []
    for head, p in zip([first, *refine], priors):
        positives, differ = check_assigner(head.assigner, p, gts.float(),
                                           labels, mask)
        if positives < 1:
            raise AssertionError(f'{label}: a stage has no positive')
        checked.append(f'{tuple(p.shape)}: {positives} positives, {differ} '
                       f'differ')
    plain = family_step(config, device, batch, True)
    worst = same_params(kernel, plain, label)
    log(f'[{label}-train-slice] float32 B={bsz} {size}^2, G={g} ({valid} '
        f'valid): priors {"; ".join(checked)} (all in the band); losses '
        f'{kernel["metrics"]} equal to the plain matrix\'s within '
        f'{LOSS_RTOL}; parameters within {worst:.3g} of each tensor\'s '
        f'change (<= {PARAM_RTOL}, or a float32 step of the value)')
    return [args for args, _ in calls]


def phase_refine_slice(device, bsz=2, size=1024, g=32, valid=8,
                       max_candidates=2000) -> dict:
    """Phase 27: S2ANet and R3Det in float32, served
    (:func:`phase_refine_serving_slice`) and trained
    (:func:`phase_refine_train_slice`), then one float32 step each, kernel
    against plain, for the KFIoU refine recipes and the two-stage cascade.
    Returns their pair-mask and IoU-matrix inputs."""
    captured = {}
    for label, config in REFINE_CONFIGS.items():
        captured[f'{label}_slice_nms'] = phase_refine_serving_slice(
            config, label, device, bsz, size, max_candidates)
        captured[f'{label}_slice_assign'] = phase_refine_train_slice(
            config, label, device, bsz, size, g, valid)
    for label, config in REFINE_RECIPES.items():
        captured[f'{label}_slice_assign'] = phase_refine_train_slice(
            config, label, device, bsz, size, g, valid)
    return captured


def refine_profile_split(prof, label) -> None:
    """One line of a profiled request's or step's device time by
    ``refine.*`` range."""
    if not prof['busy_us']:
        return
    spans = prof['spans']
    parts = ', '.join(f'{k.split(".", 1)[1]} {spans[k] / 1e3:.2f}'
                      for k in REFINE_TRAIN_RANGES + REFINE_RANGES[4:]
                      if k in spans)
    b1_us = sum(us for name, us in prof['kernels'].items()
                if 'pair_mask' in name)
    b2_us = sum(us for name, us in prof['kernels'].items()
                if 'iou_matrix_kernel' in name)
    log(f'[profile] {label} device ms by range: {parts}; nms_pair_mask '
        f'{b1_us / 1e3:.3f}, box_iou_rotated {b2_us / 1e3:.3f}')


def phase_refine_serving(device, card='', bsz=8, size=1024, warm=3,
                         timed=10, dtype=torch.bfloat16,
                         max_candidates=2000) -> tuple:
    """Phase 28: requests of ``bsz`` raw images through each refine bundle:
    imgs/s, the split between forward and decode + NMS, peak memory, one
    pair-mask launch a request; one more request's NMS inputs recorded and
    one profiled by its ``refine.*`` ranges. Returns the launch counts of
    each detector's requests and the NMS inputs by detector."""
    from orientedobjectdetection_torch.ops import nms
    on_card = torch.device(device).type == 'cuda'
    runs, captured = [], {}
    for label, config in REFINE_CONFIGS.items():
        bundle = build_refine_bundle(config, device, dtype, max_candidates)
        images = raw_images(bsz, size, 140)
        if on_card:
            images = images.pin_memory()
        fwd, dec, _, (dets, labels, valid), counts = timed_requests(
            bundle, images, warm, timed, device)
        launches = counts['nms_pair_mask']
        if launches != (warm + timed if on_card else 0):
            raise AssertionError(f'{label}: nms_pair_mask launched '
                                 f'{launches} times for {warm + timed} '
                                 f'requests')
        check_dets(dets, labels, valid, bsz, bundle.num_classes)
        mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
            else float('nan')
        log(f'[{label}-serving] {card} | {str(dtype).split(".")[-1]} '
            f'B={bsz} {size}^2, {timed} timed requests after {warm} warm: '
            f'{bsz * timed / (fwd + dec):.2f} imgs/s; per request forward '
            f'{1e3 * fwd / timed:.2f} ms, decode+NMS {1e3 * dec / timed:.2f}'
            f' ms; peak memory {mem:.2f} GiB; nms_pair_mask launches '
            f'{launches}; valid dets per image {valid.sum(1).tolist()}')
        with recording(nms, 'nms_pair_mask') as calls:
            bundle(images)
        boxes, _, cls = calls[0][0]
        captured[label] = (boxes, cls)
        prof = profile_run(lambda: bundle(images), device,
                           f'{label} request', 'refine.')
        refine_profile_split(prof, f'{label} request')
        runs.append(counts)
    return runs, captured


def time_sampling(calls, device, card, label, reps) -> dict:
    """The align / FRM sampling of one step alone, on the inputs it got
    (``recording`` of ``align_conv_sample`` or ``rotated_feature_align``):
    its forward over the levels and its backward into the features (a
    gather's backward, a scatter-add), each over ``reps`` runs."""
    fn = calls[0][2]
    feats = [args[0].detach().requires_grad_() for args, _, _ in calls]
    rest = [args[1:] for args, _, _ in calls]

    def forward():
        return [fn(f, *r) for f, r in zip(feats, rest)]

    fwd = time_ms(forward, reps, device, warmup=1)
    outs = forward()
    grads = [torch.ones_like(o) for o in outs]
    bwd = time_ms(lambda: torch.autograd.grad(outs, feats, grads,
                                              retain_graph=True),
                  reps, device, warmup=1)
    shapes = [tuple(f.shape) for f in feats]
    log(f'[{label}-training] {card} | {fn.__name__} alone on one step\'s '
        f'inputs, levels {shapes} {str(feats[0].dtype).split(".")[-1]}: '
        f'forward {fwd:.3f} ms, backward {bwd:.3f} ms')
    return dict(forward_ms=fwd, backward_ms=bwd)


def record_sampling(step_once, label) -> list:
    """One step with the refine detector's sampling function recorded:
    (args, None, the function) of each level's call."""
    from orientedobjectdetection_torch.models.detectors import \
        refine_detectors
    name = 'align_conv_sample' if label.startswith('s2anet') else \
        'rotated_feature_align'
    fn = getattr(refine_detectors, name)
    with recording(refine_detectors, name, keep_results=False) as calls:
        step_once()
    return [(args, None, fn) for args, _ in calls]


def phase_refine_training(device, card='', bsz=8, size=1024, g=32, valid=8,
                          warm=2, timed=5, dtype=torch.bfloat16,
                          padded_g=512, padded_valid=64, reps=10) -> tuple:
    """Phase 29: each refine detector trained as phase 25 trains a recipe
    (imgs/s, peak memory, two IoU-matrix launches a step: the first
    stage's shared anchors and the refine stage's per-image rois), one
    profiled step split by the ``train.*`` and ``refine.*`` ranges, one
    step at the loader's padding, and the align / FRM sampling alone on a
    step's inputs. Returns the launch counts and the recorded IoU-matrix
    inputs of one step at G=``g`` and of the padded step."""
    runs, captured = [], {}
    for label, config in REFINE_CONFIGS.items():
        run = phase_family_training(
            config, label, device, card, bsz, size, g, valid, warm, timed,
            dtype, profile=True, padded_g=padded_g,
            padded_valid=padded_valid)
        runs.append(run['counts'])
        captured[f'{label}_train'] = run['inputs']
        captured[f'{label}_train_padded'] = run['padded_inputs']
        captured[f'{label}_sampling'] = time_sampling(
            record_sampling(run['step_once'], label), device, card, label,
            reps)
    return runs, captured


def phase_refine_loops(root, work_root, card='', configs=None, steps=20,
                       dtype=torch.bfloat16, device='cuda',
                       log_interval=5) -> tuple:
    """Phase 30: the S2ANet and R3Det tiny-synth configs through
    ``train_detector`` on phase 18's set as phase 26 runs its families (two
    IoU-matrix launches a step, the evaluation's NMS and IoUs)."""
    configs = configs or REFINE_TINY_CONFIGS
    return phase_family_loops(root, work_root, card, configs, steps, dtype,
                              device, log_interval,
                              per_step={k: 2 for k in configs})


def held_refine(device, captured, by_name, card, reps, plain_reps) -> None:
    """Phases 27-30's recorded inputs against their plain versions, the
    largest of each kind timed into ``main_path_inputs``: B1 on each refine
    detector's slice and served requests' candidates (top-k over all
    levels at once) and on the tiny loops' evaluations; B2 on each train
    step's first-stage input (gts x shared anchors) and refine input (gts
    x each image's own rois), at G=32 and at the loader's G=512, and on the
    slices' and tiny loops' inputs."""
    pair, iou = by_name['nms_pair_mask'], by_name['box_iou_rotated']
    for label in REFINE_CONFIGS:
        held_pair_masks(captured[f'{label}_slice_nms'] + [captured[label]],
                        f'{label} slice and served requests', label, pair,
                        device, card, reps, plain_reps)
        for key, stage in ((f'{label}_train', 'G=32'),
                           (f'{label}_train_padded', 'G=512')):
            first, *refine = captured[key]
            held_iou_matrices([first], f'{label} first stage\'s assigner '
                              f'({stage})', f'{key}_first', iou, device,
                              card, reps, plain_reps)
            held_iou_matrices(refine, f'{label} refine assigner ({stage}, '
                              f'each image\'s rois)', f'{key}_refine', iou,
                              device, card, reps, plain_reps)
    for label in list(REFINE_CONFIGS) + list(REFINE_RECIPES):
        held_iou_matrices(captured.get(f'{label}_slice_assign', []),
                          f'{label} float32 slice step', f'{label}_slice',
                          iou, device, card, reps, plain_reps)
    for label in REFINE_TINY_CONFIGS:
        held_iou_matrices(captured[f'{label}_loop_assign'], f'tiny {label} '
                          f'loop\'s assigners', f'{label}_loop_assign', iou,
                          device, card, reps, plain_reps)
        held_iou_matrices(captured[f'{label}_loop_eval_iou'], f'tiny '
                          f'{label} loop\'s evaluation',
                          f'{label}_loop_eval_iou', iou, device, card, reps,
                          plain_reps)
        held_pair_masks(captured[f'{label}_loop_nms'], f'tiny {label} '
                        f'loop\'s evaluation', f'{label}_loop_nms', pair,
                        device, card, reps, plain_reps)


# ---- 31.-34. the horizontal-proposal two-stage families -------------------
HBB_CONFIGS = {
    'faster': os.path.join(ROOT, 'configs', 'rotated_faster_rcnn',
                           'rotated_faster_rcnn_r50_fpn_1x_dota_le90.py'),
    'gv': os.path.join(ROOT, 'configs', 'gliding_vertex',
                       'gliding_vertex_r50_fpn_1x_dota_le90.py'),
    'roitrans': os.path.join(ROOT, 'configs', 'roi_trans',
                             'roi_trans_r50_fpn_1x_dota_le90.py'),
}
HBB_TINY_CONFIGS = {
    'faster': os.path.join(ROOT, 'configs', 'rotated_faster_rcnn',
                           'rotated_faster_rcnn_tiny_synth.py'),
    'gv': os.path.join(ROOT, 'configs', 'gliding_vertex',
                       'gliding_vertex_tiny_synth.py'),
    'roitrans': os.path.join(ROOT, 'configs', 'roi_trans',
                             'roi_trans_tiny_synth.py'),
}
# RoIAlign launches a request (RoI Transformer pools once a stage) and
# IoU-matrix launches a train step (the RPN's assigner and each RoI stage's)
HBB_POOLS = {'faster': 1, 'gv': 1, 'roitrans': 2}
HBB_ASSIGNS = {'faster': 2, 'gv': 2, 'roitrans': 3}
# phase 33's steps: (warm, timed)
HBB_STEPS = {'faster': (2, 5), 'gv': (2, 5), 'roitrans': (3, 10)}
# the samplers' ranges: no host synchronisation inside them
HBB_SAMPLERS = ('two_stage.rpn_targets', 'two_stage.sample_rois',
                'two_stage.sample_rois_0', 'two_stage.sample_rois_1')


def seed_hbb_detections(detector) -> None:
    """The RPN's and every RoI stage's regression scaled down, as
    :func:`seed_refine_detections` does: proposals near their anchors and
    each stage's boxes near its RoIs, so RoI Transformer's stage-1 RoIs
    stay where a trained detector's are."""
    with torch.no_grad():
        detector.rpn_head.rpn_reg.weight.mul_(0.05)
        for name, module in detector.roi_head.named_modules():
            if name.split('.')[-1] == 'fc_reg':
                module.weight.mul_(0.05)


def build_hbb_bundle(config, device, dtype, max_num=2000,
                     max_candidates=2000, seed=0):
    """:func:`build_orcnn_bundle` for a horizontal-proposal detector
    (:func:`seed_hbb_detections`)."""
    from orientedobjectdetection_torch.apis import init_detector
    from orientedobjectdetection_torch.utils import Config
    cfg = Config.fromfile(config)
    bundle = init_detector(cfg, device=device, dtype=dtype, seed=seed,
                           device_norm=cfg.img_norm_cfg)
    det = bundle.detector
    det.test_cfg['rpn']['max_per_img'] = max_num
    det.test_cfg['rcnn']['max_candidates'] = max_candidates
    seed_hbb_detections(det)
    return bundle


def hbb_cut(outputs, max_candidates) -> torch.Tensor:
    """Per image, the lowest (RoI, class) score entering NMS."""
    if 'roi_outputs' in outputs:
        logits = outputs['roi_outputs']['cls_score']
    elif 'head_outputs' in outputs:
        logits = outputs['head_outputs'][0]
    else:
        logits = outputs['cls_score']
    scores = torch.softmax(logits.float(), -1)[..., :-1].flatten(1)
    return scores.topk(min(max_candidates, scores.shape[1]))[0][:, -1]


def pooled_inputs(calls) -> list:
    """(levels, RoIs, sampling ratio) of recorded RoIAlign-kernel calls."""
    return [(args[0], args[1], args[4]) for args, _ in calls]


def phase_hbb_serving_slice(config, label, device, bsz=2, size=1024,
                            max_num=2000, max_candidates=2000) -> dict:
    """float32: the detections with the RoIAlign kernel equal those with
    its plain version, and the same outputs decoded with the pair-mask
    kernel and with its plain version give the same detections, up to
    near-ties in score (:func:`same_detections`). Returns the request's
    RoIAlign inputs and pair-mask inputs."""
    from orientedobjectdetection_torch.apis import DetectorBundle
    from orientedobjectdetection_torch.models.roi_heads import (
        oriented_roi_head)
    from orientedobjectdetection_torch.ops import nms
    bundle = build_hbb_bundle(config, device, torch.float32, max_num,
                              max_candidates)
    plain_roi, plain_mask = (
        DetectorBundle(bundle.cfg, bundle.detector, torch.float32,
                       device_norm=bundle.device_norm, **{switch: True})
        for switch in ('plain_roi_align', 'plain_pair_mask'))
    images = raw_images(bsz, size, 150)
    with recording(oriented_roi_head, 'roi_align_rotated_pyramid',
                   keep_results=False) as pools, \
            recording(nms, 'nms_pair_mask') as masks:
        outputs = bundle.forward(images)
        got = bundle.decode(outputs)
    sync(device)
    check_dets(*got, bsz, bundle.num_classes)
    if len(pools) != ROI_POOLS[label]:
        raise AssertionError(f'{label}: {len(pools)} RoIAlign calls a '
                             f'request')
    cut = hbb_cut(outputs, max_candidates)
    mask_err, mask_moved, mask_aside = same_detections(
        got, plain_mask.decode(outputs), cut)
    roi_err, roi_moved, roi_aside = same_detections(
        got, plain_roi.decode(plain_roi.forward(images)), cut)
    sync(device)
    rois = [tuple(r.shape) for _, r, _ in pooled_inputs(pools)]
    log(f'[{label}-slice] float32 B={bsz} {size}^2: RoIAlign kernel and '
        f'plain version give the same detections (max |diff| '
        f'{roi_err:.3g}; {roi_moved} rows within {SCORE_BAND} in score in '
        f'another place, {roi_aside} set aside at the NMS cut), pair-mask '
        f'kernel and plain mask too (max |diff| {mask_err:.3g}; '
        f'{mask_moved} moved, {mask_aside} set aside); RoIAlign inputs '
        f'{rois}; valid dets per image {got[2].sum(1).tolist()}')
    return {f'{label}_slice_roi': pooled_inputs(pools),
            f'{label}_slice_nms': [(args[0], args[2]) for args, _ in masks]}


def hbb_anchor_view(size, device, config=None) -> tuple:
    """The RPN's anchors of a ``size`` x ``size`` image as its assigner
    compares them (theta-0 rotated boxes), and the gts' view there (their
    circumscribed horizontal boxes): the horizontal RPN's of Gliding Vertex
    by default, or ``config``'s (an oriented RPN assigns the same way)."""
    from orientedobjectdetection_torch.models import build_detector
    from orientedobjectdetection_torch.ops.boxes import obb2hbb
    from orientedobjectdetection_torch.utils import Config
    rpn = build_detector(dict(Config.fromfile(
        config or HBB_CONFIGS['gv']).model)).rpn_head
    sizes = [(-(-size // s[1]), -(-size // s[0]))
             for s in rpn.prior_generator.strides]
    return [rpn.train_anchors(sizes, device)[1]], \
        lambda gts: obb2hbb(gts, rpn.version)


def phase_hbb_train_slice(config, label, device, bsz=2, size=1024, g=32,
                          valid=8, check_detector=None) -> list:
    """float32: one step from one seeded state with the IoU-matrix kernel
    and one with the plain matrix, on gts whose RPN assignment is decided
    (:func:`well_posed_batch` on the RPN's anchors). Each assigner (the
    RPN's, each RoI stage's on the proposals or RoIs it got) assigns alike
    with both outside ASSIGN_BAND (:func:`check_assigner`); the losses
    agree within LOSS_RTOL and the parameters as :func:`same_params` says.
    ``check_detector``: called with the kernel step's detector. Returns the
    kernel step's IoU-matrix inputs."""
    from orientedobjectdetection_torch.ops import iou_kernels
    anchors, view = hbb_anchor_view(size, device, config)
    batch = well_posed_batch(bsz, size, g, valid, 160, device,
                             thresholds=(0.3, 0.7), anchor_sets=anchors,
                             view=view)
    with recording(iou_kernels, 'box_iou_rotated_matrix') as calls:
        kernel = family_step(config, device, batch, False)
    rpn = [args for args, _ in calls if args[1].dim() == 2]
    roi = [args for args, _ in calls if args[1].dim() == 3]
    if len(rpn) != 1 or len(roi) != ASSIGNS[label] - 1:
        raise AssertionError(f'{label}: {len(calls)} IoU matrices a step')
    if check_detector is not None:
        check_detector(kernel['detector'])
    mask = batch['gt_mask'].to(device)
    labels = torch.zeros_like(batch['gt_labels']).to(device)
    first, *stages = assigners(kernel['detector'])
    checked = []
    for assigner, (gts, priors, _), name in zip(
            [first, *stages], rpn + roi,
            ['RPN'] + [f'RoI stage {i}' for i in range(len(roi))]):
        positives, differ = check_assigner(assigner, priors, gts, labels,
                                           mask)
        if positives < 1 or (differ and name != 'RPN'):
            raise AssertionError(f'{label} {name}: {positives} positives, '
                                 f'{differ} assigned differently')
        checked.append(f'{name} {tuple(priors.shape)}: {positives} '
                       f'positives, {differ} differ')
    plain = family_step(config, device, batch, True)
    worst = same_params(kernel, plain, label)
    log(f'[{label}-train-slice] float32 B={bsz} {size}^2, G={g} ({valid} '
        f'valid): {"; ".join(checked)} (in the band); losses '
        f'{kernel["metrics"]} equal to the plain matrix\'s within '
        f'{LOSS_RTOL}; parameters within {worst:.3g} of each tensor\'s '
        f'change (<= {PARAM_RTOL}, or a float32 step of the value)')
    return [args for args, _ in calls]


def phase_hbb_slice(device, bsz=2, size=1024, g=32, valid=8, max_num=2000,
                    max_candidates=2000) -> dict:
    """Phase 31: Rotated Faster R-CNN, Gliding Vertex and RoI Transformer
    in float32, served (:func:`phase_hbb_serving_slice`) and trained
    (:func:`phase_hbb_train_slice`). Returns their kernel inputs."""
    captured = {}
    for label, config in HBB_CONFIGS.items():
        captured.update(phase_hbb_serving_slice(
            config, label, device, bsz, size, max_num, max_candidates))
        captured[f'{label}_slice_assign'] = phase_hbb_train_slice(
            config, label, device, bsz, size, g, valid)
    return captured


def phase_hbb_serving(device, card='', bsz=8, size=1024, warm=3, timed=10,
                      dtype=torch.bfloat16, max_num=2000,
                      max_candidates=2000) -> tuple:
    """Phase 32: requests of ``bsz`` raw images through each bundle:
    imgs/s, forward / decode + NMS, peak memory, RoIAlign launches a
    request (1, 1, 2) and one pair-mask launch; one more request's kernel
    inputs recorded; one RoI Transformer request profiled by its
    ``two_stage.*`` ranges, each stage's RoIAlign in its own. Returns the
    launch counts and the inputs."""
    from orientedobjectdetection_torch.models.roi_heads import (
        oriented_roi_head)
    from orientedobjectdetection_torch.ops import nms
    on_card = torch.device(device).type == 'cuda'
    runs, captured = [], {}
    for label, config in HBB_CONFIGS.items():
        bundle = build_hbb_bundle(config, device, dtype, max_num,
                                  max_candidates)
        images = raw_images(bsz, size, 170)
        if on_card:
            images = images.pin_memory()
        fwd, dec, _, (dets, labels, valid), counts = timed_requests(
            bundle, images, warm, timed, device)
        n = warm + timed if on_card else 0
        expected = {'roi_align_rotated': HBB_POOLS[label] * n,
                    'nms_pair_mask': n, 'box_iou_rotated': 0}
        if counts != expected:
            raise AssertionError(f'{label}: launches in {warm + timed} '
                                 f'requests {counts}, expected {expected}')
        check_dets(dets, labels, valid, bsz, bundle.num_classes)
        mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
            else float('nan')
        log(f'[{label}-serving] {card} | {str(dtype).split(".")[-1]} '
            f'B={bsz} {size}^2, {timed} timed requests after {warm} warm: '
            f'{bsz * timed / (fwd + dec):.2f} imgs/s; per request forward '
            f'{1e3 * fwd / timed:.2f} ms, decode+NMS {1e3 * dec / timed:.2f}'
            f' ms; peak memory {mem:.2f} GiB; launches in {warm + timed} '
            f'requests: roi_align_rotated {counts["roi_align_rotated"]}, '
            f'nms_pair_mask {counts["nms_pair_mask"]}; valid dets per image '
            f'{valid.sum(1).tolist()}')
        with recording(nms, 'nms_pair_mask') as masks, \
                recording(oriented_roi_head, 'roi_align_rotated_pyramid',
                          keep_results=False) as pools:
            bundle(images)
        captured[label] = (masks[0][0][0], masks[0][0][2])
        captured[f'{label}_roi'] = pooled_inputs(pools)
        if label == 'roitrans':
            prof = profile_run(lambda: bundle(images), device,
                               'roitrans request', 'two_stage.')
            if prof['busy_us']:
                b3_us = sum(us for k, us in prof['kernels'].items()
                            if 'roi_align_rotated_kernel' in k)
                b1_us = sum(us for k, us in prof['kernels'].items()
                            if 'pair_mask' in k)
                log(f'[profile] roitrans request: roi_align_rotated '
                    f'{b3_us / 1e3:.3f} ms in {HBB_POOLS[label]} launches, '
                    f'one in each of two_stage.roialign_head_0 and _1 '
                    f'(their extents above); nms_pair_mask '
                    f'{b1_us / 1e3:.3f} ms')
        runs.append(counts)
        del bundle
    return runs, captured


def profile_hbb_step(step, device, label) -> None:
    """One train step under the profiler, split by the ``train.*`` and
    ``two_stage.*`` ranges. Fails if a host read of a device value ran
    inside the RPN targets or a RoI stage's sampler."""
    prof = profile_run(step, device, f'{label} train step',
                       ('train.', 'two_stage.'))
    found = syncs_inside(prof['prof'], HBB_SAMPLERS)
    if any(found.values()):
        raise AssertionError(f'{label}: host synchronisation inside the '
                             f'sampler: {found}')
    ran = [k for k in HBB_SAMPLERS if k in prof['spans']]
    log(f'[profile] {label}: no host synchronisation inside {ran}')


def phase_hbb_training(device, card='', bsz=8, size=1024, g=32, valid=8,
                       dtype=torch.bfloat16, padded_g=512, padded_valid=64,
                       steps=None, reps=10) -> tuple:
    """Phase 33: each family trained on one fixed batch
    (:func:`phase_family_training`: imgs/s, peak memory, 2 / 2 / 3
    IoU-matrix launches a step and none of the other kernels, a falling
    loss, one step at the loader's padding), one step profiled with no
    host sync inside the samplers; for RoI Transformer the gather pooling
    of each stage alone on a step's inputs. Returns the launch counts, and
    the IoU-matrix inputs of one step at G=``g`` and of the padded step.
    Every step samples with one key, so the loss compares like with
    like."""
    from orientedobjectdetection_torch.core import SampleKey
    from orientedobjectdetection_torch.models.roi_heads import (
        oriented_roi_head)
    on_card = torch.device(device).type == 'cuda'
    runs, captured = [], {}
    for label, config in HBB_CONFIGS.items():
        warm, timed = (steps or HBB_STEPS)[label]
        run = phase_family_training(
            config, label, device, card, bsz, size, g, valid, warm, timed,
            dtype, padded_g=padded_g, padded_valid=padded_valid,
            falling=True, rng=SampleKey(step=0))
        counts = run['counts']
        expected = {'box_iou_rotated': HBB_ASSIGNS[label] * (warm + timed)
                    if on_card else 0,
                    'roi_align_rotated': 0, 'nms_pair_mask': 0}
        if counts != expected:
            raise AssertionError(f'{label}: launches in {warm + timed} '
                                 f'steps {counts}, expected {expected}')
        runs.append(counts)
        captured[f'{label}_train'] = run['inputs']
        captured[f'{label}_train_padded'] = run['padded_inputs']
        profile_hbb_step(run['step_once'], device, label)
        if label == 'roitrans':
            with recording(oriented_roi_head, 'roi_align_rotated',
                           keep_results=False) as pools:
                run['step_once']()
            if len(pools) != 2:
                raise AssertionError(f'{len(pools)} gather poolings a step')
            captured['roitrans_gather'] = [
                time_gather_pooling(args, device, card, reps,
                                    label=f'roitrans stage {i}')
                for i, (args, _) in enumerate(pools)]
    return runs, captured


def phase_hbb_loops(root, work_root, card='', configs=None, steps=20,
                    dtype=torch.bfloat16, device='cuda',
                    log_interval=5) -> tuple:
    """Phase 34: the three tiny-synth configs through ``train_detector`` on
    phase 18's set as phase 26 runs its families (2 / 2 / 3 IoU-matrix
    launches a step; the evaluation's RoIAlign, NMS and IoUs)."""
    configs = configs or HBB_TINY_CONFIGS
    return phase_family_loops(root, work_root, card, configs, steps, dtype,
                              device, log_interval,
                              per_step={k: HBB_ASSIGNS[k] for k in configs})


def held_roi_inputs(calls, label, key, roi, device, card, reps,
                    plain_reps) -> None:
    """Every (levels, RoIs, sampling ratio) of ``calls`` against the plain
    version (ROI_RTOL, ROI_BF16_STEP); the largest timed beside its bound
    into ``roi['main_path_inputs'][key]``."""
    if not calls:
        raise AssertionError(f'the {label} gave no RoIAlign input')
    errs = [check_roi_align(levels, rois, False, padding=False, ratio=ratio)
            for levels, rois, ratio in calls]
    roi['max_abs_err'] = max([roi['max_abs_err']] + errs)
    levels, rois, ratio = max(calls, key=lambda c: c[1].shape[0] *
                              c[1].shape[1])
    cells, live, per_level = roi_align_work(levels, rois, ratio=ratio)
    theta0 = int(((rois[..., 4] == 0) & (rois[..., 2] > 1e-3)).sum())
    log(f'[main-path] roi_align_rotated on the {len(calls)} inputs of the '
        f'{label}, largest B={rois.shape[0]} R={rois.shape[1]} '
        f'C={levels[0].shape[-1]} {str(levels[0].dtype).split(".")[-1]} '
        f'sampling_ratio={ratio}: max |kernel - plain| {max(errs):.3g}; '
        f'{live} live RoIs ({theta0} at theta 0), per level {per_level}, '
        f'{cells} feature cells touched')
    timing = time_roi_align(levels, rois, (cells, live), device, card,
                            f'{label}\'s largest input', reps, plain_reps,
                            ratio=ratio)
    roi['main_path_inputs'][key] = dict(
        timing, live_rois=live, rois_per_level=per_level, cells=cells,
        sampling_ratio=ratio, theta0_rois=theta0, inputs_held=len(calls))


def held_hbb(device, captured, by_name, card, reps, roi_reps,
             plain_reps) -> None:
    """Phases 31-34's recorded inputs against their plain versions, the
    largest of each kind timed into ``main_path_inputs``: B3 on each
    family's served RoIs (Faster R-CNN's and Gliding Vertex's theta-0
    proposals, RoI Transformer's theta-0 stage 0 and rotated stage 1) and
    on the float32 slices' and the tiny loops' evaluations; B1 on each
    family's slice and served candidates and the loops' evaluations; B2
    on each train step's RPN input (gts x the shared anchors) and each RoI
    stage's (gts x each image's proposals or RoIs), at G=32 and at the
    loader's G=512, and on the slices' and the loops' inputs."""
    held_two_stage(device, captured, by_name, card, reps, roi_reps,
                   plain_reps, HBB_CONFIGS, HBB_TINY_CONFIGS)


def held_two_stage(device, captured, by_name, card, reps, roi_reps,
                   plain_reps, configs, tiny_configs) -> None:
    """:func:`held_hbb` for the two-stage detectors ``configs`` and the
    tiny loops ``tiny_configs``."""
    pair, iou = by_name['nms_pair_mask'], by_name['box_iou_rotated']
    roi = by_name['roi_align_rotated']
    for label in configs:
        for stage, inputs in enumerate(captured[f'{label}_roi']):
            held_roi_inputs([inputs], f'{label} request (stage {stage})',
                            f'{label}_s{stage}', roi, device, card,
                            roi_reps, plain_reps)
        held_roi_inputs(captured[f'{label}_slice_roi'], f'{label} float32 '
                        f'slice', f'{label}_slice', roi, device, card,
                        roi_reps, plain_reps)
        held_pair_masks(captured[f'{label}_slice_nms'] + [captured[label]],
                        f'{label} slice and served requests', label, pair,
                        device, card, reps, plain_reps)
        held_train_matrices(captured, label, iou, device, card, reps,
                            plain_reps)
        held_iou_matrices(captured[f'{label}_slice_assign'], f'{label} '
                          f'float32 slice step', f'{label}_slice', iou,
                          device, card, reps, plain_reps)
    for label in tiny_configs:
        held_iou_matrices(captured[f'{label}_loop_assign'], f'tiny {label} '
                          f'loop\'s assigners', f'{label}_loop_assign', iou,
                          device, card, reps, plain_reps)
        held_iou_matrices(captured[f'{label}_loop_eval_iou'], f'tiny '
                          f'{label} loop\'s evaluation',
                          f'{label}_loop_eval_iou', iou, device, card, reps,
                          plain_reps)
        held_pair_masks(captured[f'{label}_loop_nms'], f'tiny {label} '
                        f'loop\'s evaluation', f'{label}_loop_nms', pair,
                        device, card, reps, plain_reps)
        held_roi_inputs(captured[f'{label}_loop_roi_align'], f'tiny {label} '
                        f'loop\'s evaluation', f'{label}_loop_eval', roi,
                        device, card, roi_reps, plain_reps)


def held_train_matrices(captured, label, iou, device, card, reps,
                        plain_reps) -> None:
    """B2 on a two-stage train step's RPN input (gts x the shared anchors)
    and each RoI stage's (gts x each image's proposals or RoIs), at G=32
    and at the loader's G=512."""
    for key, stage in ((f'{label}_train', 'G=32'),
                       (f'{label}_train_padded', 'G=512')):
        calls = captured[key]
        held_iou_matrices([c for c in calls if c[1].dim() == 2],
                          f'{label} RPN assigner ({stage})',
                          f'{key}_rpn', iou, device, card, reps,
                          plain_reps)
        for i, c in enumerate(c for c in calls if c[1].dim() == 3):
            held_iou_matrices([c], f'{label} RoI stage {i} assigner '
                              f'({stage}, each image\'s proposals)',
                              f'{key}_roi{i}', iou, device, card, reps,
                              plain_reps)


# ---- 35-38. the other backbones (Swin, ConvNeXt) and ReDet ---------------
BACKBONE_CONFIGS = {
    'swin': os.path.join(ROOT, 'configs', 'oriented_rcnn',
                         'oriented_rcnn_swin_tiny_fpn_1x_dota_le90.py'),
    'convnext': os.path.join(
        ROOT, 'configs', 'convnext',
        'rotated_retinanet_obb_kld_stable_convnext_adamw_fpn_1x_dota_le90'
        '.py'),
    'redet': os.path.join(ROOT, 'configs', 'redet',
                          'redet_re50_refpn_1x_dota_le90.py'),
}
REDET_TINY_CONFIGS = {
    'redet': os.path.join(ROOT, 'configs', 'redet', 'redet_tiny_synth.py'),
}
# RoIAlign launches a request and IoU-matrix launches a train step
BACKBONE_POOLS = {'swin': 1, 'convnext': 0, 'redet': 1}
BACKBONE_ASSIGNS = {'swin': 2, 'convnext': 1, 'redet': 2}
ROI_POOLS = {**HBB_POOLS, **BACKBONE_POOLS}
ASSIGNS = {**HBB_ASSIGNS, **BACKBONE_ASSIGNS}
# phase 37's steps: (warm, timed)
BACKBONE_STEPS = {'swin': (2, 5), 'convnext': (2, 5), 'redet': (2, 5)}
# the detector's modules that a profiled request or step splits by, each
# in a ``module.<name>`` range
PROFILED_MODULES = ('backbone', 'neck', 'rpn_head', 'roi_head', 'bbox_head')


def two_stage(label) -> bool:
    return BACKBONE_POOLS[label] > 0


@contextlib.contextmanager
def module_ranges(detector, names=PROFILED_MODULES):
    """Each of the detector's modules ``names`` runs its forward inside a
    ``record_function`` range ``module.<name>`` while the context is open
    (an instance attribute over the class's ``forward``)."""
    from torch.profiler import record_function
    wrapped = []
    for name in names:
        module = getattr(detector, name, None)
        if module is None:
            continue

        def forward(*args, _forward=module.forward, _name=name, **kwargs):
            with record_function(f'module.{_name}'):
                return _forward(*args, **kwargs)

        module.forward = forward
        wrapped.append(module)
    try:
        yield
    finally:
        for module in wrapped:
            del module.forward


def check_redet_frozen(detector) -> None:
    """ReDet at ``frozen_stages=1`` trains its stem and freezes layer1, as
    the JAX package does."""
    frozen = {n for n, p in detector.named_parameters()
              if not p.requires_grad}
    layer1 = {n for n, _ in detector.named_parameters()
              if n.startswith('backbone.layer1.')}
    if frozen != layer1 or not layer1:
        raise AssertionError(f'ReDet freezes {sorted(frozen)[:4]}..., not '
                             f'layer1 alone')
    log(f'[redet-train-slice] {len(frozen)} tensors frozen (layer1); the '
        f'stem (backbone.conv1, backbone.bn1) trains')


def phase_backbone_slice(device, bsz=2, size=1024, g=32, valid=8,
                         max_num=2000, max_candidates=2000) -> dict:
    """Phase 35: Swin-T Oriented R-CNN, ConvNeXt-T KLD-stable RetinaNet and
    ReDet ReR50-ReFPN at their DOTA configs in float32: the two-stage
    detectors served with the RoIAlign kernel and with its plain version,
    and decoded with the pair-mask kernel and its plain version
    (:func:`phase_hbb_serving_slice`; ReDet's RoIAlign inputs are its
    levels before the orientation roll), a train step with the IoU-matrix
    kernel and one with the plain matrix on gts whose RPN assignment is
    decided (:func:`phase_hbb_train_slice`; ReDet's layer1 frozen and its
    stem trained); the RetinaNet as phase 25 holds its R50 sibling
    (:func:`phase_family_slice`, :func:`phase_family_train_slice`).
    Returns the two-stage detectors' kernel inputs."""
    captured = {}
    for label, config in BACKBONE_CONFIGS.items():
        if not two_stage(label):
            phase_family_slice(config, label, device, bsz, size,
                               max_candidates)
            phase_family_train_slice(config, label, device, bsz, size, g,
                                     valid)
            continue
        captured.update(phase_hbb_serving_slice(
            config, label, device, bsz, size, max_num, max_candidates))
        captured[f'{label}_slice_assign'] = phase_hbb_train_slice(
            config, label, device, bsz, size, g, valid,
            check_redet_frozen if label == 'redet' else None)
    return captured


def build_backbone_bundle(label, device, dtype, max_num=2000,
                          max_candidates=2000):
    """Phase 35-36's bundle of ``label``: seeded weights made to give real
    boxes (:func:`seed_hbb_detections` or :func:`seed_detections`)."""
    config = BACKBONE_CONFIGS[label]
    if two_stage(label):
        return build_hbb_bundle(config, device, dtype, max_num,
                                max_candidates)
    return build_bundle(device, dtype, max_candidates, config=config)


def profile_modules(bundle, images, device, label) -> None:
    """One request profiled with the detector's modules in their own
    ranges (``module.*``), ReDet's orientation roll in its own
    (``two_stage.ri_roll``, inside ``module.roi_head``) and the decode +
    NMS in ``request.decode_nms``; the top device kernels follow."""
    from torch.profiler import record_function

    def request():
        outputs = bundle.forward(images)
        with record_function('request.decode_nms'):
            bundle.decode(outputs)

    with module_ranges(bundle.detector):
        prof = profile_run(request, device, f'{label} request',
                           ('module.', 'two_stage.', 'request.'))
    if prof['busy_us']:
        spans = prof['spans']
        log(f'[profile] {label} request by module (device ms in its '
            f'kernels): ' + ', '.join(
                f'{k} {v / 1e3:.2f}' for k, v in spans.items()))


def phase_backbone_serving(device, card='', bsz=8, size=1024, warm=3,
                           timed=10, dtype=torch.bfloat16, max_num=2000,
                           max_candidates=2000) -> tuple:
    """Phase 36: requests of ``bsz`` raw images through each bundle:
    imgs/s, forward / decode + NMS, peak memory, RoIAlign launches a
    request (1 / 0 / 1) and one pair-mask launch; one more request's kernel
    inputs recorded; one request profiled by module
    (:func:`profile_modules`). Returns the launch counts and the
    inputs."""
    from orientedobjectdetection_torch.models.roi_heads import (
        oriented_roi_head)
    from orientedobjectdetection_torch.ops import nms
    on_card = torch.device(device).type == 'cuda'
    runs, captured = [], {}
    for label in BACKBONE_CONFIGS:
        bundle = build_backbone_bundle(label, device, dtype, max_num,
                                       max_candidates)
        images = raw_images(bsz, size, 180)
        if on_card:
            images = images.pin_memory()
        fwd, dec, _, (dets, labels, valid), counts = timed_requests(
            bundle, images, warm, timed, device)
        n = warm + timed if on_card else 0
        expected = {'roi_align_rotated': ROI_POOLS[label] * n,
                    'nms_pair_mask': n, 'box_iou_rotated': 0}
        if counts != expected:
            raise AssertionError(f'{label}: launches in {warm + timed} '
                                 f'requests {counts}, expected {expected}')
        check_dets(dets, labels, valid, bsz, bundle.num_classes)
        mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
            else float('nan')
        log(f'[{label}-serving] {card} | {str(dtype).split(".")[-1]} '
            f'B={bsz} {size}^2, {timed} timed requests after {warm} warm: '
            f'{bsz * timed / (fwd + dec):.2f} imgs/s; per request forward '
            f'{1e3 * fwd / timed:.2f} ms, decode+NMS {1e3 * dec / timed:.2f}'
            f' ms; peak memory {mem:.2f} GiB; launches in {warm + timed} '
            f'requests: roi_align_rotated {counts["roi_align_rotated"]}, '
            f'nms_pair_mask {counts["nms_pair_mask"]}; valid dets per image '
            f'{valid.sum(1).tolist()}')
        with recording(nms, 'nms_pair_mask') as masks, \
                recording(oriented_roi_head, 'roi_align_rotated_pyramid',
                          keep_results=False) as pools:
            bundle(images)
        captured[label] = (masks[0][0][0], masks[0][0][2])
        if two_stage(label):
            captured[f'{label}_roi'] = pooled_inputs(pools)
        profile_modules(bundle, images, device, label)
        runs.append(counts)
        del bundle
    return runs, captured


def phase_backbone_training(device, card='', bsz=8, size=1024, g=32,
                            valid=8, dtype=torch.bfloat16, padded_g=512,
                            padded_valid=64, steps=None) -> tuple:
    """Phase 37: each detector trained on one fixed batch with its config's
    optimizer (:func:`phase_family_training`: imgs/s, peak memory, 2 / 1 /
    2 IoU-matrix launches a step and none of the other kernels, a falling
    loss, one step at the loader's padding); one step profiled by the
    ``train.*``, ``two_stage.*`` and ``module.*`` ranges, with no host
    sync inside the RPN targets or the RoI sampler. Returns the launch
    counts, and the IoU-matrix inputs of one step at G=``g`` and of the
    padded step. A two-stage detector samples with one key every step, so
    the loss compares like with like."""
    from orientedobjectdetection_torch.core import SampleKey
    on_card = torch.device(device).type == 'cuda'
    runs, captured = [], {}
    for label, config in BACKBONE_CONFIGS.items():
        warm, timed = (steps or BACKBONE_STEPS)[label]
        run = phase_family_training(
            config, label, device, card, bsz, size, g, valid, warm, timed,
            dtype, padded_g=padded_g, padded_valid=padded_valid,
            falling=True, rng=SampleKey(step=0) if two_stage(label)
            else None)
        counts = run['counts']
        expected = {'box_iou_rotated': ASSIGNS[label] * (warm + timed)
                    if on_card else 0,
                    'roi_align_rotated': 0, 'nms_pair_mask': 0}
        if counts != expected:
            raise AssertionError(f'{label}: launches in {warm + timed} '
                                 f'steps {counts}, expected {expected}')
        runs.append(counts)
        captured[f'{label}_train'] = run['inputs']
        captured[f'{label}_train_padded'] = run['padded_inputs']
        with module_ranges(run['detector']):
            prof = profile_run(run['step_once'], device,
                               f'{label} train step',
                               ('train.', 'two_stage.', 'module.'))
        found = syncs_inside(prof['prof'], HBB_SAMPLERS)
        if any(found.values()):
            raise AssertionError(f'{label}: host synchronisation inside '
                                 f'the sampler: {found}')
        if two_stage(label):
            ran = [k for k in HBB_SAMPLERS if k in prof['spans']]
            log(f'[profile] {label}: no host synchronisation inside {ran}')
    return runs, captured


def phase_redet_loop(root, work_root, card='', configs=None, steps=20,
                     dtype=torch.bfloat16, device='cuda',
                     log_interval=5) -> tuple:
    """Phase 38: ``redet_tiny_synth.py`` through ``train_detector`` on
    phase 18's set as phase 34 runs its families (2 IoU-matrix launches a
    step; the evaluation's RoIAlign, NMS and IoUs), every input
    recorded."""
    configs = configs or REDET_TINY_CONFIGS
    return phase_family_loops(root, work_root, card, configs, steps, dtype,
                              device, log_interval,
                              per_step={k: 2 for k in configs})


def held_backbones(device, captured, by_name, card, reps, roi_reps,
                   plain_reps) -> None:
    """Phases 35-38's recorded inputs against their plain versions, the
    largest of each kind timed into ``main_path_inputs``: the two-stage
    detectors' as :func:`held_two_stage` holds them (B3 on Swin Oriented
    R-CNN's proposals and on ReDet's ReFPN levels before the roll), and
    the ConvNeXt RetinaNet's served candidates (B1) and assigner inputs
    (B2) at G=32 and at the loader's G=512."""
    held_two_stage(device, captured, by_name, card, reps, roi_reps,
                   plain_reps,
                   {k: v for k, v in BACKBONE_CONFIGS.items()
                    if two_stage(k)}, REDET_TINY_CONFIGS)
    pair, iou = by_name['nms_pair_mask'], by_name['box_iou_rotated']
    held_pair_masks([captured['convnext']], 'ConvNeXt RetinaNet request',
                    'convnext', pair, device, card, reps, plain_reps)
    for key, stage in (('convnext_train', 'G=32'),
                       ('convnext_train_padded', 'G=512')):
        held_iou_matrices(captured[key], f'ConvNeXt RetinaNet assigner '
                          f'({stage})', key, iou, device, card, reps,
                          plain_reps)


# ---- 39.-42. the point-set families -----------------------------------------
REPPOINTS_CONFIGS = {
    'rotated': os.path.join(ROOT, 'configs', 'rotated_reppoints',
                            'rotated_reppoints_r50_fpn_1x_dota_oc.py'),
    'oriented': os.path.join(ROOT, 'configs', 'oriented_reppoints',
                             'oriented_reppoints_r50_fpn_1x_dota_le135.py'),
    'g': os.path.join(ROOT, 'configs', 'g_reppoints',
                      'g_reppoints_r50_fpn_1x_dota_le135.py'),
    'sasm': os.path.join(ROOT, 'configs', 'sasm_reppoints',
                         'sasm_reppoints_r50_fpn_1x_dota_oc.py'),
    'cfa': os.path.join(ROOT, 'configs', 'cfa',
                        'cfa_r50_fpn_1x_dota_le135.py'),
}
# the families served in phase 40 (SASM and CFA serve as Rotated RepPoints)
REPPOINTS_SERVED = ('rotated', 'oriented', 'g')
# phase 41's steps at the loader's padding: the two convex-IoU assigners
REPPOINTS_PADDED = ('rotated', 'sasm')
REPPOINTS_TINY_CONFIGS = {
    'oriented': os.path.join(ROOT, 'configs', 'oriented_reppoints',
                             'oriented_reppoints_tiny_synth.py'),
    'sasm': os.path.join(ROOT, 'configs', 'sasm_reppoints',
                         'sasm_tiny_synth.py'),
    'cfa': os.path.join(ROOT, 'configs', 'cfa', 'cfa_tiny_synth.py'),
    'g': os.path.join(ROOT, 'configs', 'g_reppoints',
                      'g_reppoints_tiny_synth.py'),
}
# the heads' record_function ranges, serving and training
REPPOINTS_RANGES = ('reppoints.towers', 'reppoints.sample',
                    'reppoints.heads', 'reppoints.decode_nms')
REPPOINTS_TRAIN_RANGES = ('reppoints.targets', 'reppoints.loss')
# the targets that hold a discrete choice: equal on the card and the CPU
DISCRETE_TARGETS = ('init_w', 'pos_r', 'neg_r', 'labels_r', 'keep')
# the seeded initial points: a 3 x 3 grid this many cells apart
POINT_GRID_CELLS = 2.0


def spread_point_sets(head, cells=POINT_GRID_CELLS) -> None:
    """Seeded point-set weights with a real hull: the two point outputs'
    weights x 0.05, the initial points' bias on a 3 x 3 grid ``cells``
    apart (``(dy, dx)`` per point), the refinement's bias 0. Seeded as they
    come, the 9 points of a set nearly coincide: ``min_area_polygons``
    finds no edge longer than 1e-9 and gives a zero box, and ``gmm_fit``
    gives ``eps I``."""
    grid = torch.tensor([-cells, 0.0, cells])
    gy, gx = torch.meshgrid(grid, grid, indexing='ij')
    offsets = torch.stack([gy.reshape(-1), gx.reshape(-1)], -1).reshape(-1)
    with torch.no_grad():
        for conv in (head.reppoints_pts_init_out,
                     head.reppoints_pts_refine_out):
            conv.weight.mul_(0.05)
        head.reppoints_pts_init_out.bias.copy_(offsets)
        head.reppoints_pts_refine_out.bias.zero_()


def build_reppoints_bundle(config, device, dtype, max_candidates=2000,
                           seed=0):
    """:func:`build_bundle` for a point-set detector: its points spread
    (:func:`spread_point_sets`) and its class bias zeroed (scores near 0.5,
    above score_thr)."""
    from orientedobjectdetection_torch.apis import init_detector
    from orientedobjectdetection_torch.utils import Config
    cfg = Config.fromfile(config)
    bundle = init_detector(cfg, device=device, dtype=dtype, seed=seed,
                           device_norm=cfg.img_norm_cfg)
    head = bundle.detector.bbox_head
    head.test_cfg['max_candidates'] = max_candidates
    spread_point_sets(head)
    with torch.no_grad():
        head.reppoints_cls_out.bias.zero_()
    return bundle


def reppoints_nms_cut(bundle, outputs) -> torch.Tensor:
    """Per image, the lowest score entering NMS: the ``max_candidates``-th
    (candidate, class) score of the top ``nms_pre`` locations."""
    from orientedobjectdetection_torch.ops.nms import topk_candidates
    head = bundle.detector.bbox_head
    cfg = head.test_cfg
    with torch.inference_mode():
        scores = torch.sigmoid(head._flat(outputs)[0])
        k = min(int(cfg.get('nms_pre', 2000)), scores.shape[1])
        top = topk_candidates(scores.amax(-1), k)[1]
        sel = scores.gather(1, top[..., None].expand(
            -1, -1, scores.shape[-1])).flatten(1)
        n = min(int(cfg.get('max_candidates', 2000)), sel.shape[1])
        return sel.topk(n)[0][:, -1]


def phase_reppoints_serving_slice(config, label, device, bsz=2, size=1024,
                                  max_candidates=2000) -> list:
    """float32: the same outputs decoded with the pair-mask kernel and with
    its plain version give the same detections (:func:`same_detections`).
    Returns the request's pair-mask inputs (boxes, class ids)."""
    from orientedobjectdetection_torch.apis import DetectorBundle
    from orientedobjectdetection_torch.ops import nms
    bundle = build_reppoints_bundle(config, device, torch.float32,
                                    max_candidates)
    plain = DetectorBundle(bundle.cfg, bundle.detector, torch.float32,
                           device_norm=bundle.device_norm,
                           plain_pair_mask=True)
    outputs = bundle.forward(raw_images(bsz, size, 190))
    with recording(nms, 'nms_pair_mask') as calls:
        got = bundle.decode(outputs)
    sync(device)
    check_dets(*got, bsz, bundle.num_classes)
    err, moved, aside = same_detections(got, plain.decode(outputs),
                                        reppoints_nms_cut(bundle, outputs))
    log(f'[{label}-slice] float32 B={bsz} {size}^2: kernel and plain pair '
        f'mask give the same detections (max |diff| {err:.3g}; {moved} rows '
        f'within {SCORE_BAND} in score in another place, {aside} set aside '
        f'at the NMS cut); valid dets per image {got[2].sum(1).tolist()}')
    return [(args[0], args[2]) for args, _ in calls]


def to_device(tree, device):
    """Nested tuples and lists of tensors moved to ``device``."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)


def reppoints_targets(head, outputs, gts) -> tuple:
    """The head's targets and loss terms (float32) of ``outputs`` against
    ``gts`` (gt_bboxes, gt_labels, gt_mask), on the outputs' device."""
    tg = head.targets(outputs, *gts)
    with torch.no_grad():
        losses = head.losses(head.flat_outputs(outputs), tg)
    return tg, {k: float(v) for k, v in losses.items()}


def phase_reppoints_train_slice(config, label, device, bsz=2, size=1024,
                                g=32, valid=8) -> None:
    """float32: one step's targets computed on the card equal those the
    same code computes on the CPU from the same outputs (the init and
    refine assignments and positives, SASM's positives, CFA's and APAA's
    keeps, exactly; the target polygons within 1e-3 px); the loss terms
    agree within LOSS_RTOL; the train step is finite. The targets run no
    kernel, so this is the check of the card's sorts and tie breaks. For a
    MaxConvexIoU assigner, the chunked convex IoU equals one whole chunk
    bit for bit."""
    from orientedobjectdetection_torch.models.dense_heads import \
        rotated_reppoints_head as rp
    from orientedobjectdetection_torch.ops.boxes import obb2poly
    from orientedobjectdetection_torch.ops.points import (CONVEX_IOU_PAIRS,
                                                          convex_iou)
    from orientedobjectdetection_torch.parallel.train_state import \
        normalize_images
    from orientedobjectdetection_torch.utils import Config
    detector, state, step = build_trainer(device, torch.float32,
                                          config=config)
    head = detector.bbox_head
    batch = train_batch(bsz, size, g, valid, 150, device)
    norm = Config.fromfile(config).img_norm_cfg
    images = normalize_images(batch['images'].to(device), norm)
    with torch.no_grad():
        outputs = detector(images.permute(0, 3, 1, 2))
    gts = [batch[k].to(device) for k in ('gt_bboxes', 'gt_labels',
                                         'gt_mask')]
    t0 = time.perf_counter()
    card, card_losses = reppoints_targets(head, outputs, gts)
    sync(device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host, host_losses = reppoints_targets(
        head, to_device(outputs, 'cpu'), [t.cpu() for t in gts])
    host_s = time.perf_counter() - t0
    for k in DISCRETE_TARGETS:
        if k in card and not torch.equal(card[k].cpu(), host[k]):
            n = int((card[k].cpu() != host[k]).sum())
            raise AssertionError(f'{label}: {k} differs between the card and '
                                 f'the CPU at {n} points')
    pos_i, pos_r = host['init_w'] > 0, host['pos_r']
    if not torch.equal(card['arg_r'].cpu()[pos_r], host['arg_r'][pos_r]):
        raise AssertionError(f'{label}: a positive\'s gt differs')
    err = max(float((card[k].cpu()[m] - host[k][m]).abs().max())
              for k, m in (('init_tgt', pos_i), ('ref_tgt', pos_r)))
    if err > 1e-3:
        raise AssertionError(f'{label}: target polygons differ by {err}')
    for k, v in host_losses.items():
        if abs(card_losses[k] - v) > LOSS_RTOL * abs(v):
            raise AssertionError(f'{label}: {k} {card_losses[k]} on the card '
                                 f'vs {v} on the CPU')
    kept = f', {int(host["keep"].sum())} kept' if 'keep' in host else ''
    chunks = ''
    if isinstance(head._assigners()[1], rp.MaxConvexIoUAssigner):
        sets = head.flat_outputs(outputs)['init'].detach()
        polys = obb2poly(gts[0].float(), head.version)
        whole = convex_iou(sets, polys, pairs=1 << 40)
        if not torch.equal(convex_iou(sets, polys), whole):
            raise AssertionError(f'{label}: the chunked convex IoU differs '
                                 f'from one whole chunk')
        chunks = (f'; convex_iou in chunks of {CONVEX_IOU_PAIRS} pairs '
                  f'equals one chunk of {sets.shape[1] * g * bsz} bit for '
                  f'bit')
    state, metrics = step(state, batch)
    sync(device)
    check_metrics(metrics)
    log(f'[{label}-train-slice] float32 B={bsz} {size}^2, G={g} ({valid} '
        f'valid): {int(pos_i.sum())} init and {int(pos_r.sum())} refine '
        f'positives{kept}, equal on the card and the CPU (targets '
        f'{card_s:.2f} s on the card, {host_s:.2f} s on the CPU); losses '
        f'{card_losses} within {LOSS_RTOL}{chunks}; the step finite')


def phase_reppoints_slice(device, bsz=2, size=1024, g=32, valid=8,
                          max_candidates=2000) -> dict:
    """Phase 39: the served families decoded with the pair-mask kernel and
    its plain version (:func:`phase_reppoints_serving_slice`), and every
    family's targets on the card against the CPU
    (:func:`phase_reppoints_train_slice`). Returns the pair-mask inputs."""
    captured = {}
    for label in REPPOINTS_SERVED:
        captured[f'{label}_slice_nms'] = phase_reppoints_serving_slice(
            REPPOINTS_CONFIGS[label], label, device, bsz, size,
            max_candidates)
    for label, config in REPPOINTS_CONFIGS.items():
        phase_reppoints_train_slice(config, label, device, bsz, size, g,
                                    valid)
    return captured


def reppoints_profile_split(prof, label) -> None:
    """One line of a profiled request's or step's device time by
    ``reppoints.*`` range, with the sampling's share of the busy time."""
    if not prof['busy_us']:
        return
    spans = prof['spans']
    parts = ', '.join(f'{k.split(".", 1)[1]} {spans[k] / 1e3:.2f}'
                      for k in REPPOINTS_RANGES + REPPOINTS_TRAIN_RANGES
                      if k in spans)
    b1_us = sum(us for name, us in prof['kernels'].items()
                if 'pair_mask' in name)
    share = 100 * spans.get('reppoints.sample', 0) / prof['busy_us']
    log(f'[profile] {label} device ms by range: {parts}; the sampling '
        f'{share:.1f}% of busy; nms_pair_mask {b1_us / 1e3:.3f}')


def phase_reppoints_serving(device, card='', bsz=8, size=1024, warm=3,
                            timed=10, dtype=torch.bfloat16,
                            max_candidates=2000) -> tuple:
    """Phase 40: requests of ``bsz`` raw images through Rotated RepPoints,
    Oriented RepPoints and G-RepPoints: imgs/s, forward / decode + NMS,
    peak memory, one pair-mask launch a request and no other; one more
    request's NMS inputs recorded and one profiled by its ``reppoints.*``
    ranges. Returns the launch counts and the NMS inputs by family."""
    from orientedobjectdetection_torch.ops import nms
    on_card = torch.device(device).type == 'cuda'
    runs, captured = [], {}
    for label in REPPOINTS_SERVED:
        bundle = build_reppoints_bundle(REPPOINTS_CONFIGS[label], device,
                                        dtype, max_candidates)
        images = raw_images(bsz, size, 200)
        if on_card:
            images = images.pin_memory()
        fwd, dec, _, (dets, labels, valid), counts = timed_requests(
            bundle, images, warm, timed, device)
        n = warm + timed if on_card else 0
        expected = {'nms_pair_mask': n, 'box_iou_rotated': 0,
                    'roi_align_rotated': 0}
        if counts != expected:
            raise AssertionError(f'{label}: launches in {warm + timed} '
                                 f'requests {counts}, expected {expected}')
        check_dets(dets, labels, valid, bsz, bundle.num_classes)
        mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
            else float('nan')
        log(f'[{label}-serving] {card} | {str(dtype).split(".")[-1]} '
            f'B={bsz} {size}^2, {timed} timed requests after {warm} warm: '
            f'{bsz * timed / (fwd + dec):.2f} imgs/s; per request forward '
            f'{1e3 * fwd / timed:.2f} ms, decode+NMS {1e3 * dec / timed:.2f}'
            f' ms; peak memory {mem:.2f} GiB; nms_pair_mask launches '
            f'{counts["nms_pair_mask"]}; valid dets per image '
            f'{valid.sum(1).tolist()}')
        with recording(nms, 'nms_pair_mask') as calls:
            bundle(images)
        boxes, _, cls = calls[0][0]
        captured[label] = (boxes, cls)
        prof = profile_run(lambda: bundle(images), device,
                           f'{label} request', 'reppoints.')
        reppoints_profile_split(prof, f'{label} request')
        runs.append(counts)
        del bundle
    return runs, captured


def time_convex_iou(calls, device, card, label, reps) -> dict:
    """The refine assigner's convex IoU alone on the inputs of one step
    (``recording`` of the head module's ``convex_iou``)."""
    from orientedobjectdetection_torch.ops.points import convex_iou
    sets, polys = calls[0][0][:2]
    ms = time_ms(lambda: convex_iou(sets, polys), reps, device, warmup=1)
    pairs = sets.shape[0] * sets.shape[1] * polys.shape[1]
    log(f'[{label}-training] {card} | convex_iou alone on one step\'s '
        f'inputs {tuple(sets.shape)} x {tuple(polys.shape)}: {ms:.2f} ms '
        f'({pairs} pairs, {1e6 * ms / pairs:.3f} ns a pair)')
    return dict(ms=ms, pairs=pairs)


def phase_reppoints_training(device, card='', bsz=8, size=1024, g=32,
                             valid=8, warm=2, timed=5, dtype=torch.bfloat16,
                             padded_g=512, padded_valid=64, reps=5) -> tuple:
    """Phase 41: each family trained on one fixed batch with its config's
    optimizer (:func:`phase_family_training`: imgs/s, peak memory, no kernel
    launch, a falling loss; Rotated RepPoints and SASM, the two convex-IoU
    assigners, one step at the loader's padding too); one step profiled by
    the ``train.*`` and ``reppoints.*`` ranges with no host sync inside
    ``reppoints.targets``; the deformable sampling of one step alone
    (forward and backward), and Rotated RepPoints' convex IoU alone at G=``g``
    and G=``padded_g``. Returns the launch counts and the timings."""
    from orientedobjectdetection_torch.models.dense_heads import \
        rotated_reppoints_head as rp
    runs, captured = [], {}
    for label, config in REPPOINTS_CONFIGS.items():
        padded = label in REPPOINTS_PADDED
        run = phase_family_training(
            config, label, device, card, bsz, size, g, valid, warm, timed,
            dtype, padded_g=padded_g if padded else 0,
            padded_valid=padded_valid, falling=True)
        if any(run['counts'].values()):
            raise AssertionError(f'{label}: a kernel launched in training: '
                                 f'{run["counts"]}')
        runs.append(run['counts'])
        prof = profile_run(run['step_once'], device, f'{label} train step',
                           ('train.', 'reppoints.'))
        reppoints_profile_split(prof, f'{label} train step')
        found = syncs_inside(prof['prof'], REPPOINTS_TRAIN_RANGES[:1])
        if any(found.values()):
            raise AssertionError(f'{label}: host synchronisation inside the '
                                 f'targets: {found}')
        log(f'[profile] {label}: no host synchronisation inside '
            f'reppoints.targets')
        with recording(rp, 'deform_conv_sample', keep_results=False) as calls:
            run['step_once']()
        captured[f'{label}_sampling'] = time_sampling(
            [(tuple(a.detach() if torch.is_tensor(a) else a for a in args),
              None, rp.deform_conv_sample) for args, _ in calls],
            device, card, label, reps)
        if label == 'rotated':
            with recording(rp, 'convex_iou', keep_results=False) as calls:
                run['step_once']()
            captured['convex_iou_g32'] = time_convex_iou(
                calls, device, card, label, reps)
            with recording(rp, 'convex_iou', keep_results=False) as calls:
                run['step_on'](train_batch(bsz, size, padded_g, padded_valid,
                                           110, device))
            captured['convex_iou_g512'] = time_convex_iou(
                calls, device, card, label, 2)
        del run
    return runs, captured


def phase_reppoints_loops(root, work_root, card='', configs=None, steps=20,
                          dtype=torch.bfloat16, device='cuda',
                          log_interval=5) -> tuple:
    """Phase 42: the Oriented RepPoints, SASM, CFA and G-RepPoints
    tiny-synth configs through ``train_detector`` on phase 18's set as phase
    26 runs its families (no IoU-matrix launch in training: the point-set
    assigners use the convex IoU; the evaluation's NMS and IoUs)."""
    configs = configs or REPPOINTS_TINY_CONFIGS
    return phase_family_loops(root, work_root, card, configs, steps, dtype,
                              device, log_interval,
                              per_step={k: 0 for k in configs})


def held_reppoints(device, captured, by_name, card, reps, plain_reps) -> None:
    """Phases 39-42's recorded inputs against their plain versions, the
    largest of each kind timed into ``main_path_inputs``: B1 on the served
    families' slice and request candidates (the top 2000 over all levels)
    and on the tiny loops' evaluations, B2 on the evaluations' IoUs."""
    pair, iou = by_name['nms_pair_mask'], by_name['box_iou_rotated']
    for label in REPPOINTS_SERVED:
        held_pair_masks(captured[f'{label}_slice_nms'] + [captured[label]],
                        f'{label} RepPoints slice and served requests',
                        f'reppoints_{label}', pair, device, card, reps,
                        plain_reps)
    for label in REPPOINTS_TINY_CONFIGS:
        held_iou_matrices(captured[f'{label}_loop_eval_iou'], f'tiny '
                          f'{label} RepPoints loop\'s evaluation',
                          f'reppoints_{label}_loop_eval_iou', iou, device,
                          card, reps, plain_reps)
        held_pair_masks(captured[f'{label}_loop_nms'], f'tiny {label} '
                        f'RepPoints loop\'s evaluation',
                        f'reppoints_{label}_loop_nms', pair, device, card,
                        reps, plain_reps)


# ---- 43-46. the RotatedYOLOv8 / jy stack and live BatchNorm ----------------
YOLO_CONFIGS = {
    'prototype4': os.path.join(ROOT, 'configs', 'jy', 'prototype4.py'),
    'obj1x1': os.path.join(ROOT, 'configs', 'jy', 'objectness-loss3.py'),
    'prototype3': os.path.join(ROOT, 'configs', 'jy', 'prototype3.py'),
    'msdcn': os.path.join(ROOT, 'configs', 'jy',
                          'expaned-neck-msdcn-head.py'),
}
# phase 43's float32 slice and phase 44's served models (requests a model)
YOLO_SLICE = ('prototype4', 'obj1x1')
YOLO_SERVED = {'prototype4': 10, 'prototype3': 5, 'msdcn': 5}
YOLO_TINY_CONFIGS = {
    'yolov8': os.path.join(ROOT, 'configs', 'jy',
                           'rotated_yolov8_tiny_synth.py'),
}
YOLO_RANGES = ('module.backbone', 'module.neck', 'module.bbox_head',
               'yolov8.msarc', 'yolov8.dcn_sample', 'yolov8.decode_nms')
YOLO_TRAIN_RANGES = ('yolov8.targets', 'yolov8.loss')
# phase 43's live step: the running statistics against the EMA of the
# biased batch variance computed from the layer's input by a hook (the
# same reductions; float32 rounding of the EMA)
BN_RTOL = 1e-6


def zero_yolo_class_bias(head) -> None:
    """Seeded weights made to give real boxes: the class bias
    ``log(5 / num_classes / (1024 / stride)^2)`` puts every score under
    score_thr; zeroed, scores start near 0.5."""
    with torch.no_grad():
        for name in head.prior_biases():
            if name.startswith(('cls_pred_', 'fg_pred_')):
                getattr(head, name).bias.zero_()


def build_yolo_bundle(config, device, dtype, max_candidates=2000, seed=0):
    """:func:`build_bundle` for a YOLOv8 detector, its class bias zeroed
    (:func:`zero_yolo_class_bias`)."""
    from orientedobjectdetection_torch.apis import init_detector
    from orientedobjectdetection_torch.utils import Config
    cfg = Config.fromfile(config)
    bundle = init_detector(cfg, device=device, dtype=dtype, seed=seed,
                           device_norm=cfg.img_norm_cfg)
    head = bundle.detector.bbox_head
    head.test_cfg['max_candidates'] = max_candidates
    zero_yolo_class_bias(head)
    return bundle


def yolo_nms_cut(bundle, outputs) -> torch.Tensor:
    """Per image, the lowest score entering NMS: the ``max_candidates``-th
    (point, class) score of the top ``nms_pre`` points."""
    from orientedobjectdetection_torch.models.dense_heads.rotated_fcos_head \
        import _flat
    from orientedobjectdetection_torch.ops.nms import topk_candidates
    head = bundle.detector.bbox_head
    cfg = head.test_cfg
    with torch.inference_mode():
        logits = head.score_logits(outputs)
        flat = _flat(logits, logits[0].shape[0], head.num_classes).float()
        k = min(int(cfg.get('nms_pre', 2000)), flat.shape[1])
        top = topk_candidates(flat.amax(-1), k)[1]
        scores = torch.sigmoid(flat.gather(1, top[..., None].expand(
            -1, -1, flat.shape[-1]))).flatten(1)
        n = min(int(cfg.get('max_candidates', 2000)), scores.shape[1])
        return scores.topk(n)[0][:, -1]


def phase_yolo_serving_slice(config, label, device, bsz=2, size=1024,
                             max_candidates=2000) -> list:
    """float32: the same outputs decoded with the pair-mask kernel and with
    its plain version give the same detections (:func:`same_detections`).
    Returns the request's pair-mask inputs (boxes, class ids)."""
    from orientedobjectdetection_torch.apis import DetectorBundle
    from orientedobjectdetection_torch.ops import nms
    bundle = build_yolo_bundle(config, device, torch.float32,
                               max_candidates)
    plain = DetectorBundle(bundle.cfg, bundle.detector, torch.float32,
                           device_norm=bundle.device_norm,
                           plain_pair_mask=True)
    outputs = bundle.forward(raw_images(bsz, size, 230))
    with recording(nms, 'nms_pair_mask') as calls:
        got = bundle.decode(outputs)
    sync(device)
    check_dets(*got, bsz, bundle.num_classes)
    err, moved, aside = same_detections(got, plain.decode(outputs),
                                        yolo_nms_cut(bundle, outputs))
    log(f'[{label}-slice] float32 B={bsz} {size}^2: kernel and plain pair '
        f'mask give the same detections (max |diff| {err:.3g}; {moved} rows '
        f'within {SCORE_BAND} in score in another place, {aside} set aside '
        f'at the NMS cut); valid dets per image {got[2].sum(1).tolist()}')
    return [(args[0], args[2]) for args, _ in calls]


def yolo_targets(head, outputs, gts, plain_iou) -> tuple:
    """The head's targets (labels, bbox and angle targets, positives) and
    float32 loss terms of ``outputs`` against ``gts``, the assigner's IoU
    matrix by the kernel or (``plain_iou``) by its plain version."""
    head.assigner.plain_iou = plain_iou
    try:
        tg = head.targets(outputs, *gts)
        with torch.no_grad():
            losses = head.losses(outputs, *tg)
    finally:
        head.assigner.plain_iou = False
    return tg, {k: float(v) for k, v in losses.items()}


def check_live_bn(detector, step, state, batch, device) -> str:
    """One ``norm_eval=False`` step: finite losses, and every BatchNorm's
    running statistics moved to ``0.9 old + 0.1 batch``, the batch's
    mean and BIASED variance of the layer's float32 input (hooks record
    them): within BN_RTOL of that, and nearer to it than to the EMA of the
    unbiased variance wherever the two differ."""
    from orientedobjectdetection_torch.models.blocks import FrozenBatchNorm
    norms = {n: m for n, m in detector.named_modules()
             if isinstance(m, FrozenBatchNorm)}
    before = {n: (m.running_mean.clone(), m.running_var.clone())
              for n, m in norms.items()}
    seen = {}

    def record(name):
        def hook(module, args):
            x = args[0].detach().float()
            seen[name] = (x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False),
                          x.var((0, 2, 3), unbiased=True))
        return hook

    hooks = [m.register_forward_pre_hook(record(n)) for n, m in norms.items()]
    try:
        state, metrics = step(state, batch)
    finally:
        for hook in hooks:
            hook.remove()
    sync(device)
    check_metrics(metrics)
    worst = 0.0
    for name, bn in norms.items():
        mean, biased, unbiased = seen[name]
        mean0, var0 = before[name]
        expect_var = 0.9 * var0 + 0.1 * biased
        other = 0.9 * var0 + 0.1 * unbiased
        for what, got, expect in (('mean', bn.running_mean,
                                   0.9 * mean0 + 0.1 * mean),
                                  ('var', bn.running_var, expect_var)):
            err = float(((got - expect).abs() / expect.abs().clamp(
                min=1e-6)).max())
            worst = max(worst, err)
            if err > BN_RTOL:
                raise AssertionError(f'live BN {name} running {what} off '
                                     f'the biased EMA by {err:.3g} '
                                     f'(relative)')
        apart = other != expect_var
        if ((bn.running_var - expect_var).abs() >=
                (bn.running_var - other).abs())[apart].any():
            raise AssertionError(f'live BN {name}: the running var is as '
                                 f'near the unbiased EMA as the biased one')
    return (f'live BN: {len(norms)} BatchNorms, each on the biased-variance '
            f'EMA (largest relative error {worst:.3g} <= {BN_RTOL}); losses '
            f'{ {k: round(float(v), 4) for k, v in metrics.items()} }')


def phase_yolo_train_slice(config, label, device, bsz=2, size=1024, g=32,
                           valid=8, live=False, batch=None) -> list:
    """float32: one step's assignments (labels, positives, targets) with
    the IoU-matrix kernel equal those with the plain matrix from the same
    outputs, the loss terms within LOSS_RTOL, the train step finite;
    ``live``: one more step with live BatchNorm (:func:`check_live_bn`).
    ``batch``: the step's batch (by default :func:`train_batch`'s).
    Returns the assigner's IoU-matrix inputs."""
    from orientedobjectdetection_torch.ops import iou_kernels
    from orientedobjectdetection_torch.parallel.train_state import \
        normalize_images
    from orientedobjectdetection_torch.utils import Config
    detector, state, step = build_trainer(device, torch.float32,
                                          config=config)
    head = detector.bbox_head
    if batch is None:
        batch = train_batch(bsz, size, g, valid, 170, device)
    norm = Config.fromfile(config).img_norm_cfg
    images = normalize_images(batch['images'].to(device), norm)
    with torch.no_grad():
        outputs = detector(images.permute(0, 3, 1, 2))
    gts = [batch[k].to(device) for k in ('gt_bboxes', 'gt_labels',
                                         'gt_mask')]
    with recording(iou_kernels, 'box_iou_rotated_matrix') as calls:
        card, card_losses = yolo_targets(head, outputs, gts, False)
    plain, plain_losses = yolo_targets(head, outputs, gts, True)
    sync(device)
    for i, what in enumerate(('labels', 'bbox targets', 'angle targets',
                              'positives')):
        if not torch.equal(card[i], plain[i]):
            n = int((card[i] != plain[i]).sum())
            raise AssertionError(f'{label}: {what} differ between the '
                                 f'kernel and the plain matrix at {n} '
                                 f'places')
    for k, v in plain_losses.items():
        if abs(card_losses[k] - v) > LOSS_RTOL * abs(v):
            raise AssertionError(f'{label}: {k} {card_losses[k]} with the '
                                 f'kernel vs {v} with the plain matrix')
    state, metrics = step(state, batch)
    sync(device)
    check_metrics(metrics)
    extra = ''
    if live:
        _, live_state, live_step = build_trainer(device, torch.float32,
                                                 config=config,
                                                 norm_eval=False)
        extra = '; ' + check_live_bn(live_state.model, live_step,
                                     live_state, batch, device)
    log(f'[{label}-train-slice] float32 B={bsz} {size}^2, G={g} ({valid} '
        f'valid): {int(card[3].sum())} positives; labels, targets and '
        f'positives equal with the kernel and the plain matrix; losses '
        f'{card_losses} within {LOSS_RTOL}; the step finite{extra}')
    return [args for args, _ in calls]


def phase_yolo_slice(device, bsz=2, size=1024, g=32, valid=8,
                     max_candidates=2000) -> dict:
    """Phase 43: prototype4 and the 1x1 objectness model in float32, each
    decoded with the pair-mask kernel and its plain version and assigned
    with the IoU-matrix kernel and its plain version; prototype4 also one
    live-BN step. Returns the kernels' inputs."""
    captured = {}
    for label in YOLO_SLICE:
        config = YOLO_CONFIGS[label]
        captured[f'{label}_slice_nms'] = phase_yolo_serving_slice(
            config, label, device, bsz, size, max_candidates)
        captured[f'{label}_slice_assign'] = phase_yolo_train_slice(
            config, label, device, bsz, size, g, valid,
            live=label == 'prototype4')
    return captured


def yolo_profile_split(prof, label) -> None:
    """One line of a profiled request's or step's device time by
    ``module.*`` and ``yolov8.*`` range."""
    if not prof['busy_us']:
        return
    spans = prof['spans']
    parts = ', '.join(f'{k} {spans[k] / 1e3:.2f}'
                      for k in YOLO_RANGES + YOLO_TRAIN_RANGES if k in spans)
    b1_us = sum(us for name, us in prof['kernels'].items()
                if 'pair_mask' in name)
    b2_us = sum(us for name, us in prof['kernels'].items()
                if 'iou_matrix' in name or 'box_iou' in name)
    log(f'[profile] {label} device ms by range: {parts}; nms_pair_mask '
        f'{b1_us / 1e3:.3f}, box_iou_rotated {b2_us / 1e3:.3f}')


def phase_yolo_serving(device, card='', bsz=8, size=1024, warm=3,
                       timed=None, dtype=torch.bfloat16,
                       max_candidates=2000, configs=None) -> tuple:
    """Phase 44: requests of ``bsz`` raw images through prototype4 (CSPNeXt-M
    0.67 / 0.75, 15 classes), prototype3 (CSPNeXt-L 1.0 / 1.25 with MSARC)
    and the CSPDarknet / PAFPN_E / MSDCN model: imgs/s, forward / decode +
    NMS, peak memory, one pair-mask launch a request and no other; one more
    request's NMS inputs recorded and one profiled by module and
    ``yolov8.*`` range. ``timed``: label -> timed requests
    (``YOLO_SERVED``); ``configs``: label -> config (``YOLO_CONFIGS``).
    Returns the launch counts and the NMS inputs."""
    from torch.profiler import record_function
    from orientedobjectdetection_torch.ops import nms
    on_card = torch.device(device).type == 'cuda'
    runs, captured = [], {}
    for label, n_timed in (timed or YOLO_SERVED).items():
        bundle = build_yolo_bundle((configs or YOLO_CONFIGS)[label], device,
                                   dtype, max_candidates)
        images = raw_images(bsz, size, 240)
        if on_card:
            images = images.pin_memory()
        fwd, dec, _, (dets, labels, valid), counts = timed_requests(
            bundle, images, warm, n_timed, device)
        n = warm + n_timed if on_card else 0
        expected = {'nms_pair_mask': n, 'box_iou_rotated': 0,
                    'roi_align_rotated': 0}
        if counts != expected:
            raise AssertionError(f'{label}: launches in {warm + n_timed} '
                                 f'requests {counts}, expected {expected}')
        check_dets(dets, labels, valid, bsz, bundle.num_classes)
        mem = torch.cuda.max_memory_allocated() / 2**30 if on_card \
            else float('nan')
        log(f'[{label}-serving] {card} | {str(dtype).split(".")[-1]} '
            f'B={bsz} {size}^2, {n_timed} timed requests after {warm} warm: '
            f'{bsz * n_timed / (fwd + dec):.2f} imgs/s; per request forward '
            f'{1e3 * fwd / n_timed:.2f} ms, decode+NMS '
            f'{1e3 * dec / n_timed:.2f} ms; peak memory {mem:.2f} GiB; '
            f'nms_pair_mask launches {counts["nms_pair_mask"]}; valid dets '
            f'per image {valid.sum(1).tolist()}')
        with recording(nms, 'nms_pair_mask') as calls:
            bundle(images)
        boxes, _, cls = calls[0][0]
        captured[label] = (boxes, cls)

        def request():
            outputs = bundle.forward(images)
            with record_function('yolov8.request_decode'):
                bundle.decode(outputs)

        with module_ranges(bundle.detector):
            prof = profile_run(request, device, f'{label} request',
                               ('module.', 'yolov8.'))
        yolo_profile_split(prof, f'{label} request')
        runs.append(counts)
        del bundle
    return runs, captured


def phase_yolo_training(device, card='', bsz=8, size=1024, g=32, valid=8,
                        warm=2, timed=5, dtype=torch.bfloat16, padded_g=512,
                        padded_valid=64) -> tuple:
    """Phase 45: prototype4 trained on one fixed batch with its config's SGD
    (:func:`phase_family_training`: imgs/s, peak memory, one IoU-matrix
    launch a step, a falling loss), with frozen BatchNorm (and one step at
    the loader's padding, G=``padded_g``) and with live BatchNorm; the
    frozen run's step profiled by the ``train.*`` and ``yolov8.*`` ranges
    with no host sync inside ``yolov8.targets``. Returns the launch counts
    and the assigner's inputs at G=``g`` and G=``padded_g``."""
    runs, captured = [], {}
    config = YOLO_CONFIGS['prototype4']
    for norm_eval, label in ((True, 'prototype4'),
                             (False, 'prototype4-live-bn')):
        run = phase_family_training(
            config, label, device, card, bsz, size, g, valid, warm, timed,
            dtype, padded_g=padded_g if norm_eval else 0,
            padded_valid=padded_valid, falling=True, norm_eval=norm_eval)
        runs.append(run['counts'])
        if not norm_eval:
            continue
        captured['yolov8_train'] = run['inputs']
        captured['yolov8_train_padded'] = run['padded_inputs']
        prof = profile_run(run['step_once'], device, f'{label} train step',
                           ('train.', 'yolov8.'))
        yolo_profile_split(prof, f'{label} train step')
        found = syncs_inside(prof['prof'], YOLO_TRAIN_RANGES[:1])
        if any(found.values()):
            raise AssertionError(f'{label}: host synchronisation inside the '
                                 f'targets: {found}')
        log(f'[profile] {label}: no host synchronisation inside '
            f'yolov8.targets')
        del run
    return runs, captured


def phase_yolo_loop(root, work_root, card='', configs=None, steps=20,
                    dtype=torch.bfloat16, device='cuda',
                    log_interval=5) -> tuple:
    """Phase 46: the RotatedYOLOv8 tiny-synth config through
    ``train_detector`` on phase 18's set as phase 26 runs its families (one
    IoU-matrix launch a step, the assigner's; the evaluation's NMS and
    IoUs), every kernel input recorded."""
    configs = configs or YOLO_TINY_CONFIGS
    return phase_family_loops(root, work_root, card, configs, steps, dtype,
                              device, log_interval,
                              per_step={k: 1 for k in configs})


def held_yolo(device, captured, by_name, card, reps, plain_reps) -> None:
    """Phases 43-46's recorded inputs against their plain versions, the
    largest of each kind timed into ``main_path_inputs``: B1 on the slice's
    and the served models' candidates and the tiny loop's evaluation; B2 on
    the slice's and the trained steps' assigner inputs (decoded predictions
    x gts, both batched) at G=32 and at G=512, the tiny loop's steps and its
    evaluation."""
    pair, iou = by_name['nms_pair_mask'], by_name['box_iou_rotated']
    held_pair_masks(
        [m for label in YOLO_SLICE for m in captured[f'{label}_slice_nms']],
        'YOLOv8 float32 slice', 'yolov8_slice', pair, device, card, reps,
        plain_reps)
    for label in YOLO_SERVED:
        held_pair_masks([captured[label]], f'{label} request',
                        f'yolov8_{label}', pair, device, card, reps,
                        plain_reps)
    held_iou_matrices(
        [a for label in YOLO_SLICE for a in captured[f'{label}_slice_assign']],
        'YOLOv8 float32 slice\'s assigner', 'yolov8_slice_assign', iou,
        device, card, reps, plain_reps)
    for key, stage in (('yolov8_train', 'G=32'),
                       ('yolov8_train_padded', 'G=512')):
        held_iou_matrices(captured[key], f'prototype4 assigner ({stage})',
                          key, iou, device, card, reps, plain_reps)
    for label in YOLO_TINY_CONFIGS:
        held_iou_matrices(captured[f'{label}_loop_assign'],
                          f'tiny {label} loop\'s assigner',
                          f'{label}_loop_assign', iou, device, card, reps,
                          plain_reps)
        held_iou_matrices(captured[f'{label}_loop_eval_iou'],
                          f'tiny {label} loop\'s evaluation',
                          f'{label}_loop_eval_iou', iou, device, card, reps,
                          plain_reps)
        held_pair_masks(captured[f'{label}_loop_nms'], f'tiny {label} '
                        f'loop\'s evaluation', f'{label}_loop_nms', pair,
                        device, card, reps, plain_reps)


# ---- 12. kernels on the main paths' inputs ---------------------------------
# ---- 47.-49. data parallelism and the host side ----------------------------
DP_WORLD = 2             # gloo ranks that share the card (NCCL refuses two
#                          ranks on one device)
DP_JOIN_S = 600          # each rank's time limit
DP_VALID = (8, 3)        # valid gts in the first and in the second half
DP_LOSS_RTOL = 1e-4      # ranks vs one process: losses and grad_norm
DP_CHANGE_RTOL = 2e-3    # each parameter's change, of its largest change
DP_STAT_RTOL = 1e-5      # live BN running statistics, of their largest
DP_SPREAD = 3            # live BN gradient: times the reordered steps' spread
DP_CONFIGS = {'retinanet': CONFIG,
              'prototype4': os.path.join(ROOT, 'configs', 'jy',
                                         'prototype4.py')}
SERVE_THR = 0.05


def dp_batch(bsz, size, g, valid, seed, device) -> dict:
    """Phase 8's train batch with ``valid[0]`` gts in each image of the
    first half and ``valid[1]`` in the second: the halves have different
    numbers of positives, so a rank's local normalizer is not the batch's.
    """
    batch = train_batch(bsz, size, g, valid[0], seed, 'cpu')
    half = bsz // 2
    batch['gt_mask'][half:, valid[1]:] = False
    batch['gt_bboxes'][half:, valid[1]:] = 0
    if torch.device(device).type == 'cuda':
        batch = {k: v.pin_memory() for k, v in batch.items()}
    return batch


def dp_step(config, norm_eval, batch, device, dtype=torch.float32,
            rows=None, steps=1) -> dict:
    """A fresh seeded trainer of ``config`` (:func:`build_trainer`; its
    step is data-parallel inside a process group) takes ``steps`` steps on
    ``rows`` of ``batch`` (all of it by default). Returns the first step's
    metrics, the parameters and BN statistics before it and after it (on
    the host) and its launches, and every step's milliseconds."""
    detector, state, step = build_trainer(device, dtype, config=config,
                                          norm_eval=norm_eval)
    if rows is not None:
        batch = {k: v[rows] for k, v in batch.items()}
    before = {k: v.detach().cpu().clone()
              for k, v in detector.state_dict().items()}
    out = dict(ms=[], trainable={n for n, p in detector.named_parameters()
                                 if p.requires_grad}, before=before)
    for i in range(steps):
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync(device)
        out['ms'].append(1e3 * (time.perf_counter() - t0))
        check_metrics(metrics)
        if i == 0:
            out.update(metrics={k: float(v) for k, v in metrics.items()},
                       counts=read_launches(),
                       after={k: v.detach().cpu().clone()
                              for k, v in detector.state_dict().items()})
    return out


def same_dp_step(got, ref, label, stats=False, spread=()) -> tuple:
    """A data-parallel step against one process's on the whole batch:
    losses and ``grad_norm`` within DP_LOSS_RTOL, each trainable tensor's
    change within DP_CHANGE_RTOL of that tensor's largest change plus two
    float32 ulps of its largest value, frozen tensors unchanged, and
    (``stats``) every running statistic within DP_STAT_RTOL of its
    tensor's largest magnitude.

    ``spread``: one-process steps on the same batch in other orders (the
    same step in exact arithmetic), given where the float32 gradient is not
    determined to those tolerances (prototype4 with live BN). Then
    ``grad_norm`` is held to DP_SPREAD times the most those steps differ
    from ``ref``, and the changes of all trainable tensors together (their
    difference's L2 norm) to DP_SPREAD times the most theirs differ; the
    losses and statistics as above. Returns (the largest loss difference,
    the largest change difference over its tolerance, the largest
    statistic difference over its tolerance)."""
    loss_err = 0.0
    for k, v in ref['metrics'].items():
        err = abs(got['metrics'][k] - v)
        tol = DP_LOSS_RTOL * abs(v)
        if k == 'grad_norm':
            tol = max([tol] + [DP_SPREAD * abs(r['metrics'][k] - v)
                               for r in spread])
        else:
            loss_err = max(loss_err, err / max(abs(v), 1e-12))
        if err > tol:
            raise AssertionError(f'{label}: {k} {got["metrics"][k]} vs {v}')
    worst = stat_worst = 0.0
    sq = np.zeros(1 + len(spread))
    for k, before in ref['before'].items():
        ref_after, got_after = ref['after'][k], got['after'][k]
        if k.endswith(('running_mean', 'running_var')):
            if not stats:
                continue
            tol = DP_STAT_RTOL * float(ref_after.abs().max())
            err = float((got_after - ref_after).abs().max())
            stat_worst = max(stat_worst, err / tol if tol else err)
            if err > tol:
                raise AssertionError(f'{label}: {k} differs by {err} > '
                                     f'{tol}')
            continue
        if not before.is_floating_point():
            continue
        change = ref_after - before
        if k not in ref['trainable']:
            if change.any() or not torch.equal(got_after, ref_after):
                raise AssertionError(f'{label}: {k}: frozen tensor changed')
            continue
        if spread:
            sq += [float(((a['after'][k] - ref_after).double() ** 2).sum())
                   for a in (got, *spread)]
            continue
        top = float(before.abs().max())
        tol = DP_CHANGE_RTOL * float(change.abs().max()) + 2 * float(
            np.spacing(np.float32(top)))
        err = float(((got_after - before) - change).abs().max())
        worst = max(worst, err / tol)
        if err > tol:
            raise AssertionError(f'{label}: {k}: change differs by {err} > '
                                 f'{tol}')
    if spread:
        dev, others = np.sqrt(sq[0]), np.sqrt(sq[1:]).max()
        worst = dev / (DP_SPREAD * others)
        if worst > 1:
            raise AssertionError(f'{label}: the changes differ by {dev} '
                                 f'(L2), the reordered steps\' by at most '
                                 f'{others}')
    return loss_err, worst, stat_worst


def spread_of(runs, ref) -> tuple:
    """How far one-process steps in other batch orders land from ``ref``:
    (the largest ``grad_norm`` difference relative to ``ref``'s, the
    largest change difference relative to that tensor's largest change)."""
    norm = max(abs(r['metrics']['grad_norm'] - ref['metrics']['grad_norm'])
               for r in runs) / ref['metrics']['grad_norm']
    change = 0.0
    for k in ref['trainable']:
        moved = float((ref['after'][k] - ref['before'][k]).abs().max())
        if moved:
            change = max(change, max(float((r['after'][k] - ref['after'][k])
                                           .abs().max()) for r in runs)
                         / moved)
    return norm, change


def free_card(device) -> None:
    """Hand the memory this process's allocator caches back to the card
    (other processes are about to use it)."""
    import gc
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_ranks(workdir, spec, world, timeout=DP_JOIN_S) -> list:
    """``dp_rank_main`` in ``world`` fresh processes on ``spec`` (written
    to ``workdir/spec.json``), a ``file://`` rendezvous in ``workdir``;
    each rank's output is logged with its rank. Waits for each within the
    time limit and kills them all when one fails or overruns. Returns the
    ranks' results."""
    with open(os.path.join(workdir, 'spec.json'), 'w') as f:
        json.dump(spec, f)
    init = 'file://' + os.path.join(workdir, 'rendezvous')
    code = (f'import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; '
            f'chip_smoke.dp_rank_main(int(sys.argv[1]), {world}, {init!r}, '
            f'{workdir!r})')
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, '-c', code, str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    failure = None
    try:
        for r, p in enumerate(procs):
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                out, _ = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                failure = f'rank {r} ran past {timeout} s'
                break
            for line in out.splitlines():
                if line.startswith('[rank'):
                    log(line)
            if p.returncode != 0:
                failure = f'rank {r} exited {p.returncode}:\n{out[-6000:]}'
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failure:
        raise AssertionError(failure)
    return [torch.load(os.path.join(workdir, f'rank{r}.pt'),
                       weights_only=False) for r in range(world)]


def sum_without_backward(reduce):
    """``reduce`` (a differentiable sum across ranks) with the identity in
    place of its backward: the global sum forward, while each rank's
    gradient misses the other ranks' part. Phase 47 (iii) plants it in live
    BatchNorm, a fault of the gradient alone, which its comparison must
    refuse."""
    def faulty(tensor):
        return tensor + (reduce(tensor.detach()) - tensor.detach())
    return faulty


def dp_rank_main(rank, world, init, workdir):
    """A rank of phases 47-48: joins the group ``spec.json`` names and runs
    its tasks on this rank's rows (a task with ``fault`` set runs with
    :func:`sum_without_backward` as the group's sum); writes
    ``rank<r>.pt``."""
    from orientedobjectdetection_torch.parallel import mesh
    with open(os.path.join(workdir, 'spec.json')) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = spec['device']
    mesh.init_distributed(device, backend=spec['backend'], init_method=init,
                          rank=rank, world_size=world)
    batch = mesh.shard_batch(torch.load(os.path.join(workdir, 'batch.pt')))
    per = batch['images'].shape[0]
    out = {}
    for task in spec['tasks']:
        name = task['name']
        if task['kind'] == 'step':
            reduce = mesh.all_reduce_sum
            if task.get('fault'):
                mesh.all_reduce_sum = sum_without_backward(reduce)
            try:
                out[name] = run = dp_step(
                    task['config'], task['norm_eval'], batch, device,
                    getattr(torch, task['dtype']),
                    steps=task.get('steps', 1))
            finally:
                mesh.all_reduce_sum = reduce
            log(f'[rank {rank}] {name}: {per} images of the global '
                f'{per * world}, {task["dtype"]} steps '
                f'{", ".join(f"{m:.1f}" for m in run["ms"])} ms; launches '
                f'of the first {run["counts"]}')
        else:
            out[name] = dp_eval_task(task, device, rank)
        free_card(device)
    torch.save(out, os.path.join(workdir, f'rank{rank}.pt'))
    mesh.destroy()


def dp_eval_task(task, device, rank) -> dict:
    """``batched_eval`` through ``collect_dir`` and the dataset's mAP on
    every rank's gathered results."""
    from orientedobjectdetection_torch.apis.eval import (_default_norm,
                                                         batched_eval)
    from orientedobjectdetection_torch.apis.inference import init_detector
    from orientedobjectdetection_torch.datasets import build_dataset
    cfg = synth_config(task['config'], task['root'])
    bundle = init_detector(cfg, task['weights'], device=device,
                           device_norm=_default_norm(cfg))
    val = build_dataset(dict(cfg.data['val'], test_mode=True,
                             filter_empty_gt=False))
    reset_launches()
    t0 = time.perf_counter()
    results = batched_eval(bundle, val, batch_size=task['batch_size'],
                           progress=False, collect_dir=task['collect_dir'])
    sync(device)
    seconds = time.perf_counter() - t0
    counts = read_launches()
    mean_ap = val.evaluate(results, device=device, logger='silent')['mAP']
    from orientedobjectdetection_torch.parallel import mesh
    mine = len(range(rank, len(val), mesh.world_size()))
    log(f'[rank {rank}] {task["name"]}: {mine} of {len(val)} images, '
        f'gathered in {seconds:.2f} s; launches {counts}; mAP {mean_ap:.6f}')
    return dict(results=results, map=mean_ap, counts=counts)


def phase_data_parallel(device, card='', bsz=8, size=1024, g=32,
                        valid=DP_VALID, timed=3, eval_sets=None,
                        world=DP_WORLD, single_backend='nccl') -> list:
    """Phases 47 and 48. 47: one float32 step (TF32 off) of Rotated
    RetinaNet R50-FPN and of prototype4 with live BatchNorm, on a global
    batch of ``bsz`` images whose halves hold different numbers of gts: (i)
    over ``torch.cuda.device_count()`` ranks on NCCL (one process of a
    group of one on a single card, else one process a card), equal to the
    plain ``make_train_step`` on the whole batch; (ii) over ``world`` gloo
    processes that share the card (NCCL refuses two ranks on one device),
    each on its rows, equal to one process on the whole batch
    (:func:`same_dp_step`), and (iii) the same for prototype4 with frozen
    BN, and with live BN, every running statistic included: its float32
    gradient is not determined to those tolerances (the one-process step
    on the batch in another order moves ``grad_norm`` by ~2%), so its
    ``grad_norm`` and its changes together are held to DP_SPREAD times
    the spread of two such reordered steps, and the same comparison must
    refuse the ranks' step with a fault of the gradient alone planted in
    live BN (:func:`sum_without_backward`); then ``timed`` bfloat16
    data-parallel steps a rank. 48: ``batched_eval`` over the same ranks
    through a ``collect_dir`` on ``eval_sets`` (label -> (config, data
    root, weights path)): the gathered lists equal one process's and so
    does the mAP;
    ``DetectorBundle(devices=[every local card])`` gives the one-device
    detections. Returns the ranks' and the group's launch counts."""
    import shutil
    from orientedobjectdetection_torch.apis.eval import (_default_norm,
                                                         batched_eval)
    from orientedobjectdetection_torch.apis.inference import init_detector
    from orientedobjectdetection_torch.datasets import build_dataset
    from orientedobjectdetection_torch.parallel import mesh
    on_card = torch.device(device).type == 'cuda'
    workdir = os.path.join(DATA_DIR, 'data_parallel')
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    batch = dp_batch(bsz, size, g, valid, 120, device)
    torch.save({k: v.clone() for k, v in batch.items()},
               os.path.join(workdir, 'batch.pt'))
    runs = []
    refs = {}
    for label, config, norm_eval in (
            ('retinanet', 'retinanet', True), ('prototype4', 'prototype4',
                                               False),
            ('prototype4_frozen', 'prototype4', True)):
        refs[label] = dp_step(DP_CONFIGS[config], norm_eval, batch, device)
    # prototype4's live step in two other orders of the batch: the same
    # step in exact arithmetic, whose float32 spread phase 47 (iii) reads
    half = bsz // 2
    orders = (list(range(half, bsz)) + list(range(half)),
              list(range(bsz - 1, -1, -1)))
    reordered = [dp_step(DP_CONFIGS['prototype4'], False,
                         {k: v[order] for k, v in batch.items()}, device)
                 for order in orders]
    # (i) the group of every local card over NCCL
    cards = torch.cuda.device_count() if on_card else 1
    if cards == 1:
        mesh.init_distributed(device, backend=single_backend,
                              init_method=f'tcp://127.0.0.1:{free_port()}',
                              rank=0, world_size=1)
        try:
            group = dp_step(DP_CONFIGS['retinanet'], True, batch, device)
        finally:
            mesh.destroy()
        groups = [group]
    else:
        free_card(device)
        spec = dict(device=device, backend=single_backend, tasks=[dict(
            name='retinanet', kind='step', config=DP_CONFIGS['retinanet'],
            norm_eval=True, dtype='float32')])
        groups = [r['retinanet'] for r in run_ranks(workdir, spec, cards)]
    for group in groups:
        err = same_dp_step(group, refs['retinanet'], 'NCCL group')
        runs.append(group['counts'])
    exact = all(torch.equal(groups[0]['after'][k], v)
                for k, v in refs['retinanet']['after'].items())
    retina = os.path.basename(DP_CONFIGS['retinanet'])
    log(f'[dp-training] {card} | (i) {cards} rank(s) on '
        f'{single_backend}, {retina} float32, global batch {bsz} of '
        f'{size}^2 (G={g}, {valid[0]} / {valid[1]} valid in the halves): '
        f'equal to the plain step (loss rel {err[0]:.3g}, worst change '
        f'{err[1]:.3g} of its tolerance; bit for bit: {exact}); launches '
        f'{groups[0]["counts"]}')
    # (ii) and (iii): gloo ranks sharing the card, and phase 48's sets;
    # the ranks need the card's memory that this process's cache holds
    free_card(device)
    tasks = [dict(name='retinanet', kind='step',
                  config=DP_CONFIGS['retinanet'], norm_eval=True,
                  dtype='float32'),
             dict(name='prototype4', kind='step',
                  config=DP_CONFIGS['prototype4'], norm_eval=False,
                  dtype='float32'),
             dict(name='prototype4_frozen', kind='step',
                  config=DP_CONFIGS['prototype4'], norm_eval=True,
                  dtype='float32'),
             dict(name='prototype4_fault', kind='step',
                  config=DP_CONFIGS['prototype4'], norm_eval=False,
                  dtype='float32', fault=True),
             dict(name='retinanet_bf16', kind='step',
                  config=DP_CONFIGS['retinanet'], norm_eval=True,
                  dtype='bfloat16', steps=timed + 1)]
    for label, (config, root, weights) in (eval_sets or {}).items():
        tasks.append(dict(name=f'eval_{label}', kind='eval', config=config,
                          root=root, weights=weights, batch_size=8,
                          collect_dir=os.path.join(workdir, 'collect')))
    ranks = run_ranks(workdir, dict(device=device, backend='gloo',
                                    tasks=tasks), world)
    spread = spread_of(reordered, refs['prototype4'])
    log(f'[dp-training] {card} | prototype4 live BN, one process, the batch '
        f'in two other orders: grad_norm moves by {spread[0]:.3g} of '
        f'itself, a parameter\'s change by up to {spread[1]:.3g} of its '
        f'tensor\'s largest (float32 does not determine this step further; '
        f'frozen, no order moves it)')
    for label, stats, part, others in (
            ('retinanet', False, 'ii', ()),
            ('prototype4_frozen', False, 'iii', ()),
            ('prototype4', True, 'iii', reordered)):
        errs = [same_dp_step(r[label], refs[label], f'{label} rank {i}',
                             stats, others) for i, r in enumerate(ranks)]
        launches = [r[label]['counts']['box_iou_rotated'] for r in ranks]
        runs.extend(r[label]['counts'] for r in ranks)
        gap = max(abs(r[label]['metrics']['grad_norm']
                      - refs[label]['metrics']['grad_norm'])
                  for r in ranks) / refs[label]['metrics']['grad_norm']
        log(f'[dp-training] {card} | ({part}) {world} gloo ranks sharing '
            f'the card, {label} float32, {bsz // world} images a rank: '
            f'equal to one process on all {bsz} (losses rel <= '
            f'{max(e[0] for e in errs):.3g}, grad_norm rel {gap:.3g}, worst '
            f'change {max(e[1] for e in errs):.3g} of its tolerance'
            + (f' (L2 of all changes against {DP_SPREAD} times the '
               f'reordered steps\')' if others else '')
            + (f', worst running statistic '
               f'{max(e[2] for e in errs):.3g} of its tolerance'
               if stats else '') + f'); step ms a rank '
            f'{[round(r[label]["ms"][0], 1) for r in ranks]} (one step, '
            f'first call); box_iou_rotated launches a rank {launches}')
    # the planted fault: live BN's sum without its backward changes the
    # gradient alone, and the comparison of (iii) must refuse it
    for i, r in enumerate(ranks):
        fault = r['prototype4_fault']
        gap = abs(fault['metrics']['grad_norm']
                  - refs['prototype4']['metrics']['grad_norm']) \
            / refs['prototype4']['metrics']['grad_norm']
        try:
            same_dp_step(fault, refs['prototype4'], f'fault rank {i}', True,
                         reordered)
        except AssertionError as e:
            refused = str(e)
        else:
            raise AssertionError('phase 47 (iii) takes a live-BN step '
                                 'whose sum has no backward for the right '
                                 'one: its comparison cannot see a wrong '
                                 'gradient')
        log(f'[dp-training] {card} | (iii) planted fault, rank {i}: live '
            f'BN\'s sum across ranks with the identity for its backward '
            f'(grad_norm rel {gap:.3g}) is refused: {refused}')
    runs.extend(r['retinanet_bf16']['counts'] for r in ranks)
    log(f'[dp-training] {card} | {retina} bfloat16, {world} gloo ranks '
        f'x {bsz // world} images: step ms a rank after the first '
        f'{[[round(m, 1) for m in r["retinanet_bf16"]["ms"][1:]]
            for r in ranks]}'
        f'; box_iou_rotated launches of a step a rank '
        f'{[r["retinanet_bf16"]["counts"]["box_iou_rotated"] for r in ranks]}')
    for label, (config, root, weights) in (eval_sets or {}).items():
        cfg = synth_config(config, root)
        state = weights
        val = build_dataset(dict(cfg.data['val'], test_mode=True,
                                 filter_empty_gt=False))
        bundle = init_detector(cfg, state, device=device,
                               device_norm=_default_norm(cfg))
        single = batched_eval(bundle, val, batch_size=8, progress=False)
        single_map = val.evaluate(single, device=device,
                                  logger='silent')['mAP']
        exact = True
        for i, r in enumerate(ranks):
            got = r[f'eval_{label}']
            runs.append(got['counts'])
            if len(got['results']) != len(single):
                raise AssertionError(f'{label}: rank {i} gathered '
                                     f'{len(got["results"])} images')
            for a, b in zip(got['results'], single):
                exact &= all(np.array_equal(x, y) for x, y in zip(a, b))
            err, moved, aside = same_detections(
                stack_results(got['results'], bundle.num_classes),
                stack_results(single, bundle.num_classes),
                [-1.0] * len(single))
            if abs(got['map'] - single_map) > (0 if exact else AP_ATOL):
                raise AssertionError(f'{label}: rank {i} mAP {got["map"]} '
                                     f'vs one process {single_map}')
        devices = [f'cuda:{i}' for i in range(cards)] if on_card \
            else ['cpu', 'cpu']
        split = init_detector(cfg, state, devices=devices,
                              device_norm=_default_norm(cfg))
        multi = batched_eval(split, val, batch_size=8, progress=False)
        m_err, m_moved, _ = same_detections(
            stack_results(multi, bundle.num_classes),
            stack_results(single, bundle.num_classes), [-1.0] * len(single))
        log(f'[dp-eval] {card} | {label}: {world} gloo ranks, '
            f'{len(single)} val images through collect_dir: the same lists '
            f'as one process (bit for bit: {exact}; max |diff| {err:.3g}, '
            f'{moved} rows moved), mAP {single_map:.6f} on every rank; '
            f'DetectorBundle(devices={devices}): the one-device detections '
            f'(max |diff| {m_err:.3g}, {m_moved} rows moved)')
    shutil.rmtree(os.path.join(workdir, 'collect'), ignore_errors=True)
    return runs


def phase_host(root, trained, captured, card='', device='cuda',
               n_requests=10, config=SYNTH1024_CONFIG, flops_config=CONFIG,
               flops_shape=(1024, 1024)) -> list:
    """Phase 49. ``tools.serve`` on an ephemeral localhost port over
    phase 16's trained synth1024 RetinaNet (class bias zeroed) answers
    ``n_requests`` PNG requests of the val images with
    ``inference_detector``'s detections above SERVE_THR; the native host NMS
    (``csrc/rnms.cpp``) on the largest class of phase 21's largest merge
    keeps what the pair-mask kernel's ``nms_rotated_np`` keeps, both timed;
    ``imshow_det_rbboxes`` writes one request's PNG; ``confusion_matrix``
    on phase 17's evaluation (the same weights and images); ``get_flops``
    of RetinaNet R50. Returns the launch counts of the requests, the
    kernel NMS and the confusion matrix."""
    import http.client
    import threading
    from orientedobjectdetection_torch import native
    from orientedobjectdetection_torch.apis.eval import batched_eval
    from orientedobjectdetection_torch.apis.inference import \
        inference_detector
    from orientedobjectdetection_torch.core.visualization import \
        imshow_det_rbboxes
    from orientedobjectdetection_torch.datasets import build_dataset
    from orientedobjectdetection_torch.ops.nms import nms_rotated_np
    from orientedobjectdetection_torch.tools import (confusion_matrix,
                                                     get_flops, serve)
    from orientedobjectdetection_torch.utils.image_io import imdecode
    runs = []
    weights = zero_class_bias(trained)
    ckpt = os.path.join(DATA_DIR, 'serve_ckpt.pth')
    torch.save(weights, ckpt)
    server = serve.build_server(serve.parse_args([
        config, ckpt, '--host', '127.0.0.1', '--port', '0', '--score-thr',
        str(SERVE_THR), '--device', device]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    cfg = synth_config(config, root)
    val = build_dataset(dict(cfg.data['val'], test_mode=True,
                             filter_empty_gt=False))
    images = [os.path.join(val.img_prefix, info['filename'])
              for info in val.data_infos]
    paths = [images[i % len(images)] for i in range(n_requests)]
    bundle = server.RequestHandlerClass.served
    host, port = server.server_address[:2]
    try:
        answers, seconds = [], []
        reset_launches()
        for path in paths:
            with open(path, 'rb') as f:
                body = f.read()
            t0 = time.perf_counter()
            conn = http.client.HTTPConnection(host, port, timeout=120)
            conn.request('POST', '/predict', body=body)
            reply = conn.getresponse()
            data = reply.read()
            seconds.append(time.perf_counter() - t0)
            conn.close()
            if reply.status != 200:
                raise AssertionError(f'serve answered {reply.status}: {data}')
            answers.append((json.loads(data), imdecode(body)))
        runs.append(read_launches())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    n_dets, worst = 0, 0.0
    for got, img in answers:
        ref = serve.detections_json(inference_detector(bundle, img),
                                    SERVE_THR)
        if [d['class_id'] for d in got] != [d['class_id'] for d in ref]:
            raise AssertionError('serve\'s classes differ from '
                                 'inference_detector\'s')
        for a, b in zip(got, ref):
            worst = max(worst, max(abs(x - y) for x, y in
                                   zip(a['bbox'] + [a['score']],
                                       b['bbox'] + [b['score']])))
        n_dets += len(got)
    if worst > DETS_ATOL:
        raise AssertionError(f'serve vs inference_detector: {worst}')
    ms = [1e3 * s for s in seconds]
    log(f'[serve] {card} | {len(answers)} PNG requests of '
        f'{cfg.get("pad_size")} over localhost: {n_dets} detections above '
        f'{SERVE_THR}, the JSON inference_detector\'s (max |diff| '
        f'{worst:.3g}); ms a request {[round(m, 1) for m in ms]} (median '
        f'{float(np.median(ms)):.1f}); launches {runs[-1]}')
    # the native host NMS against the kernel's on a merge class
    merges = captured.get('submission_merge') or []
    if merges:
        boxes, cls = max(merges, key=lambda m: m[0].shape[1])
        boxes, cls = boxes[0].cpu(), cls[0].cpu()
        top = int(torch.mode(cls).values)
        sel = boxes[cls == top].numpy()
        scores = np.arange(len(sel), 0, -1, dtype=np.float32)
        reps = 3
        native.load()
        t0 = time.perf_counter()
        for _ in range(reps):
            keep_native = nms_rotated_np(sel, scores, 0.1, device='cpu')
        native_ms = 1e3 * (time.perf_counter() - t0) / reps
        nms_rotated_np(sel, scores, 0.1, device=device)
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(reps):
            keep_kernel = nms_rotated_np(sel, scores, 0.1, device=device)
        sync(device)
        kernel_ms = 1e3 * (time.perf_counter() - t0) / reps
        runs.append(read_launches())
        if not np.array_equal(keep_native, keep_kernel):
            raise AssertionError(f'native NMS keeps {len(keep_native)}, the '
                                 f'kernel {len(keep_kernel)}')
        log(f'[host-nms] {card} | class {top} of phase 21\'s largest merge '
            f'(N={len(sel)} of {boxes.shape[0]}): the native NMS keeps the '
            f'{len(keep_native)} the pair-mask kernel keeps; native '
            f'{native_ms:.2f} ms, nms_rotated_np on {device} '
            f'{kernel_ms:.2f} ms a call')
    else:
        log('[host-nms] no merge recorded: not run')
    out_file = os.path.join(DATA_DIR, 'serve_request.png')
    result = inference_detector(bundle, paths[0])
    drawn = imshow_det_rbboxes(paths[0], result, class_names=val.CLASSES,
                               score_thr=SERVE_THR, out_file=out_file)
    if drawn.shape[2] != 3 or not os.path.exists(out_file):
        raise AssertionError('imshow_det_rbboxes wrote nothing')
    results = batched_eval(bundle, val, batch_size=8, progress=False)
    reset_launches()
    cm = confusion_matrix.calculate_confusion_matrix(val, results, 0.3, 0.5,
                                                     device=device)
    runs.append(read_launches())
    n = len(val.CLASSES)
    log(f'[confusion] {card} | {len(results)} val images of phase 17: '
        f'{int(cm.sum())} entries, {int(np.trace(cm[:n, :n]))} on the '
        f'diagonal, {int(cm[n].sum())} background, {int(cm[:, n].sum())} '
        f'missed; launches {runs[-1]}; drawn {os.path.basename(out_file)} '
        f'{drawn.shape}')
    from orientedobjectdetection_torch.utils import Config
    params, flops = get_flops.count(Config.fromfile(flops_config),
                                    flops_shape, device)
    log(f'[get-flops] {os.path.basename(flops_config)} at {flops_shape}: '
        f'{params} parameters (the JAX package\'s params count), '
        f'{flops / 1e9:.2f} GFLOPs by {get_flops.DEFINITION}')
    return runs


# ---- 50.-52. the YOLOv6 neck, the YOLO block library, reference weights ----
# phase 50's neck, put in prototype4's place as both packages' registries
# build it: mmyolo's YOLOv6 setting of 12 CSP blocks, make_round(12, 0.67)
# = 8 RepVGG blocks a stage, outputs 192 / 384 / 576 wide (the head's)
YOLOV6_NECK = dict(type='YOLOv6RepPAFPN', in_channels=[256, 512, 768],
                   out_channels=[256, 512, 768], deepen_factor=0.67,
                   widen_factor=0.75, num_csp_blocks=12)
DECIDED_MARGIN = 1e-4    # a decided YOLOv8 assignment's least gap
DECIDED_TRIES = 40       # gt draws tried for a decided one
# phase 51: each block's float32 output on the card against the CPU's, of
# the output's largest magnitude (TF32 off; the sums in other orders)
BLOCK_RTOL = 1e-4
BLOCK_SIZES = (128, 64, 32)      # the neck's levels of a 1024^2 image
BLOCK_WIDTHS = (192, 384, 576)   # prototype4's widths there
GUIDE = (15, 512)                # one text token a DOTA class
REDET_CONFIG = BACKBONE_CONFIGS['redet']


def yolov6_config(root=DATA_DIR) -> str:
    """Phase 50's config: a file under ``root`` whose base is prototype4's
    config and whose neck is ``YOLOV6_NECK``."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, 'prototype4_yolov6_neck.py')
    with open(path, 'w') as f:
        f.write(f'_base_ = [{YOLO_CONFIGS["prototype4"]!r}]\n'
                f'model = dict(neck=dict(_delete_=True, '
                f'**{YOLOV6_NECK!r}))\n')
    return path


def yolo_decided(head, outputs, gts, margin=DECIDED_MARGIN) -> bool:
    """Whether the assignment of ``gts`` (boxes, labels, mask) on a YOLOv8
    head's ``outputs`` is decided by more than ``margin``, the CPU tests'
    rule: each valid gt's k-th and (k+1)-th positive costs, and its best
    and second-best centerness, differ by more; the valid gts' best points
    are distinct and not point 0 (the padded gts' best); no gate (inside,
    centre radius, regress range) within 1e-3 px of its edge, in float64.
    Undecided, rounding (the kernel's or the plain matrix's) picks the
    positives."""
    gt_bboxes, gt_labels, gt_mask = gts
    with torch.no_grad():
        cls, box, ang = head._flat(outputs)
        points, strides, ranges = head.flat_points(
            [tuple(s.shape[-2:]) for s in outputs[0]], gt_bboxes.device)
        t = head.assigner.cost(points, strides, ranges, gt_bboxes, gt_labels,
                               gt_mask, box, ang, cls)
    k = head.assigner.topk
    cost = t['cost'].transpose(1, 2).sort(-1, descending=True)[0]
    kth, nxt = cost[..., k - 1], cost[..., k]
    if ((kth > 0) & (nxt > 0) & (kth - nxt <= margin))[gt_mask].any():
        return False
    top2, best = t['centerness'].transpose(1, 2).topk(2, -1)
    if ((top2[..., 0] - top2[..., 1]) <= margin)[gt_mask].any():
        return False
    for b in range(gt_mask.shape[0]):
        pts = best[b, :, 0][gt_mask[b]]
        if len(set(pts.tolist())) < len(pts) or (pts == 0).any():
            return False
    g = gt_bboxes.double()[:, None]
    p = points.double()
    dx = p[None, :, 0, None] - g[..., 0]
    dy = p[None, :, 1, None] - g[..., 1]
    ox = dx * torch.cos(g[..., 4]) + dy * torch.sin(g[..., 4])
    oy = -dx * torch.sin(g[..., 4]) + dy * torch.cos(g[..., 4])
    sides = torch.stack([g[..., 2] / 2 + ox, g[..., 3] / 2 + oy,
                         g[..., 2] / 2 - ox, g[..., 3] / 2 - oy], -1)
    radius = head.assigner.center_radius * strides.double()[None, :, None]
    max_reg = sides.amax(-1)
    edges = torch.stack([sides.amin(-1), ox.abs() - radius,
                         oy.abs() - radius,
                         max_reg - ranges.double()[None, :, 0, None],
                         max_reg - ranges.double()[None, :, 1, None]], -1)
    near = (edges.abs() <= 1e-3).any(-1)
    return not near[gt_mask[:, None, :].expand(-1, near.shape[1],
                                               -1)].any()


def decided_yolo_batch(config, bsz, size, g, valid, seed, device) -> tuple:
    """Raw images and the first of ``DECIDED_TRIES`` seeded gt draws whose
    assignment on the seeded float32 model's outputs is decided
    (:func:`yolo_decided`). Returns (batch, draws tried)."""
    from orientedobjectdetection_torch.parallel.train_state import \
        normalize_images
    from orientedobjectdetection_torch.utils import Config
    detector, _, _ = build_trainer(device, torch.float32, config=config)
    images = raw_images(bsz, size, seed)
    norm = Config.fromfile(config).img_norm_cfg
    with torch.no_grad():
        outputs = detector(normalize_images(images.to(device), norm)
                           .permute(0, 3, 1, 2))
    anchors = config_anchors(size, 'cpu')
    for k in range(DECIDED_TRIES):
        gts = seeded_gts(anchors, bsz, g, valid, seed + 1 + k)
        if yolo_decided(detector.bbox_head, outputs,
                        [t.to(device) for t in gts]):
            batch = dict(images=images, gt_bboxes=gts[0], gt_labels=gts[1],
                         gt_mask=gts[2])
            if torch.device(device).type == 'cuda':
                batch = {k: v.pin_memory() for k, v in batch.items()}
            return batch, k + 1
    raise AssertionError(f'no decided draw of gts in {DECIDED_TRIES}')


def phase_yolov6_slice(device, config=None, bsz=2, size=1024, g=32,
                       valid=8, max_candidates=2000) -> dict:
    """Phase 50 in float32: prototype4 with the YOLOv6 Rep-PAFPN neck
    (``config``, by default :func:`yolov6_config`'s), its detections with
    the pair-mask kernel equal to those with the plain mask
    (:func:`phase_yolo_serving_slice`); on gts whose assignment is decided
    (:func:`decided_yolo_batch`), one step's targets with the IoU-matrix
    kernel equal to those with the plain matrix from the same outputs
    (:func:`phase_yolo_train_slice`), and one step with the kernel and one
    with the plain matrix from one seeded state with the same losses and
    parameters (:func:`same_params`). Returns the kernels' inputs."""
    config = config or yolov6_config()
    captured = {'yolov6_slice_nms': phase_yolo_serving_slice(
        config, 'yolov6', device, bsz, size, max_candidates)}
    batch, tries = decided_yolo_batch(config, bsz, size, g, valid, 300,
                                      device)
    captured['yolov6_slice_assign'] = phase_yolo_train_slice(
        config, 'yolov6', device, bsz, size, g, valid, batch=batch)
    kernel = family_step(config, device, batch, False)
    plain = family_step(config, device, batch, True)
    worst = same_params(kernel, plain, 'yolov6')
    log(f'[yolov6-train-slice] float32 B={bsz} {size}^2, G={g} ({valid} '
        f'valid, decided at draw {tries}): a step with the IoU-matrix kernel '
        f'and one with the plain matrix from one seeded state: losses '
        f'{kernel["metrics"]} within {LOSS_RTOL}; parameters within '
        f'{worst:.3g} of each tensor\'s change (<= {PARAM_RTOL}, or a '
        f'float32 step of the value)')
    return captured


def phase_yolov6(device, card='', config=None, bsz=8, size=1024, warm=3,
                 timed=10, train_timed=5, g=32, valid=8,
                 dtype=torch.bfloat16, max_candidates=2000) -> tuple:
    """Phase 50 in bfloat16: requests of ``bsz`` raw images through the
    YOLOv6-neck model (:func:`phase_yolo_serving`: imgs/s, forward /
    decode + NMS, peak memory, one pair-mask launch a request, one request
    profiled by module), then ``warm + train_timed`` steps of its config's
    SGD with frozen BatchNorm (:func:`phase_family_training`: imgs/s, peak
    memory, one IoU-matrix launch a step, a falling loss). Returns the
    launch counts and the kernels' inputs."""
    config = config or yolov6_config()
    runs, captured = phase_yolo_serving(
        device, card, bsz, size, warm, {'yolov6': timed}, dtype,
        max_candidates, configs={'yolov6': config})
    run = phase_family_training(config, 'yolov6', device, card, bsz, size,
                                g, valid, warm, train_timed, dtype,
                                falling=True)
    runs.append(run['counts'])
    captured['yolov6_train'] = run['inputs']
    return runs, captured


def block_cases(widths=BLOCK_WIDTHS, sizes=BLOCK_SIZES, guide=GUIDE) -> dict:
    """Phase 51's cases, name -> (module factory, inputs), where a
    prototype4-width neck at 1024^2 runs them: the single-input blocks at
    the stride-8 level, the two-input fusions there (BiFusion at stride 16
    with its finer partner at stride 8), ASFF at each level over all three,
    the PSA and deformable blocks at stride 32, the text-guided blocks with
    one text token of ``guide[1]`` channels a DOTA class. An input is
    ``(channels, side)``, ``('tokens', n, channels)`` or a list of maps."""
    from orientedobjectdetection_torch.models import yolo_blocks as Y
    c, c1, c2 = widths
    m, m1, m2 = (c, sizes[0]), (c1, sizes[1]), (c2, sizes[2])
    text = ('tokens',) + tuple(guide)
    embed, heads = c // 3 * 2, 4
    pyramid = [m, m1, m2]
    cases = {
        'RepVGGBlock': (lambda: Y.RepVGGBlock(c, c), [m]),
        'RepStageBlock': (lambda: Y.RepStageBlock(c, c, 2), [m]),
        'BottleRep': (lambda: Y.BottleRep(c, c, True), [m]),
        'ConvWrapper': (lambda: Y.ConvWrapper(c, c), [m]),
        'BepC3StageBlock': (lambda: Y.BepC3StageBlock(c, c, 4), [m]),
        'SPPBottleneck': (lambda: Y.SPPBottleneck(c, c), [m]),
        'CSPSPPFBottleneck': (lambda: Y.CSPSPPFBottleneck(c, c), [m]),
        'C3': (lambda: Y.C3(c, c, 2), [m]),
        'C3k': (lambda: Y.C3k(c, c, 2), [m]),
        'C3K2': (lambda: Y.C3K2(c, c, 2), [m]),
        'CBAM': (lambda: Y.CBAM(c), [m]),
        'ESEAttn': (lambda: Y.ESEAttn(c), [m]),
        'ESE': (lambda: Y.ESE(c), [m]),
        'SpatialAttention': (lambda: Y.SpatialAttention(c), [m]),
        'C2fCBAM': (lambda: Y.C2fCBAM(c, c, 2), [m]),
        'LSKBlock': (lambda: Y.LSKBlock(c), [m]),
        'LSKAttention': (lambda: Y.LSKAttention(c), [m]),
        'ConvMlp': (lambda: Y.ConvMlp(c), [m]),
        'LSKA': (lambda: Y.LSKA(c), [m]),
        'ESELSKA': (lambda: Y.ESELSKA(c), [m]),
        'AFF': (lambda: Y.AFF(c), [m, m]),
        'iAFF': (lambda: Y.iAFF(c), [m, m]),
        'AFF_CSP': (lambda: Y.AFF_CSP(c), [m, (c // 2, sizes[0])]),
        'iAFF_CSP': (lambda: Y.iAFF_CSP(c), [m, (c // 2, sizes[0])]),
        'ASFFDown': (lambda: Y.ASFFDown(c, c), [m, m]),
        'BiFusion': (lambda: Y.BiFusion(c, c), [(c, sizes[1]),
                                                (c, sizes[1]), m]),
        'PSAAttention': (lambda: Y.PSAAttention(c2), [m2]),
        'PSABlock': (lambda: Y.PSABlock(c2), [m2]),
        'C2PSA': (lambda: Y.C2PSA(c2, c2), [m2]),
        'DCAttention': (lambda: Y.DCAttention(c2), [m2, m2]),
        'DASFF': (lambda: Y.DASFF(c2, c2), [m2, m2]),
        'DCASFF': (lambda: Y.DCASFF(c2, c2), [m2, m2]),
        'MaxSigmoidAttnBlock': (lambda: Y.MaxSigmoidAttnBlock(
            c, c, guide[1], embed, heads, with_scale=True), [m, text]),
        'RepConvMaxSigmoidAttnBlock': (lambda: Y.RepConvMaxSigmoidAttnBlock(
            c, c, guide[1], embed, heads, with_scale=True), [m, text]),
        'MaxSigmoidCSPLayerWithTwoConv': (
            lambda: Y.MaxSigmoidCSPLayerWithTwoConv(
                c, c, guide[1], embed, 2, heads, with_scale=True),
            [m, text]),
        'RepConvMaxSigmoidCSPLayerWithTwoConv': (
            lambda: Y.RepConvMaxSigmoidCSPLayerWithTwoConv(
                c, c, guide[1], embed, 2, heads, with_scale=True),
            [m, text]),
        'ImagePoolingAttentionModule': (
            lambda: Y.ImagePoolingAttentionModule(
                list(widths), guide[1], 4 * c // 3, 8, with_scale=True),
            [text, pyramid]),
    }
    for level in range(3):
        cases[f'ASFF_level{level}'] = (
            lambda level=level: Y.ASFF(list(widths), level, widths[level]),
            [pyramid])
    return cases


def block_inputs(specs, bsz, gen) -> list:
    """Seeded float32 inputs on the host for :func:`block_cases`' specs."""
    out = []
    for spec in specs:
        if isinstance(spec, list):
            out.append(block_inputs(spec, bsz, gen))
        elif spec[0] == 'tokens':
            out.append(torch.randn((bsz,) + spec[1:], generator=gen))
        else:
            out.append(torch.randn(bsz, spec[0], spec[1], spec[1],
                                   generator=gen))
    return out


def tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t) for t in tree]
    return fn(tree)


def flat_outputs(out) -> list:
    return [o for x in out for o in flat_outputs(x)] \
        if isinstance(out, (list, tuple)) else [out]


def phase_blocks(device, card='', bsz=8, reps=20, cases=None) -> list:
    """Phase 51: each of the 38 classes of ``models/yolo_blocks.py``
    (:func:`block_cases`, ASFF at each level) built with seeded weights
    and fed seeded inputs of ``bsz`` images: its float32 output on the
    device (TF32 off) against the same module's on the host for the first
    image, within BLOCK_RTOL of the output's largest magnitude (the blocks
    see each image alone: the BatchNorms are frozen); then the module in
    bfloat16 (its convolutions and linear layers, as ``init_detector``
    casts them) on the device: the forward's ms by CUDA events over
    ``reps`` runs, peak memory, a finite output. No speed limits. Returns
    one record a case."""
    import copy
    from orientedobjectdetection_torch.models.detectors.single_stage import (
        WEIGHTED_LAYERS, init_seeded_weights)
    on_card = torch.device(device).type == 'cuda'
    records = []
    t0 = time.perf_counter()
    for i, (name, (make, specs)) in enumerate(
            (cases or block_cases()).items()):
        module = make().eval()
        init_seeded_weights(module, 510 + i)
        args = block_inputs(specs, bsz, torch.Generator().manual_seed(i))
        with torch.no_grad():
            ref = flat_outputs(module(*tree_map(lambda t: t[:1], args)))
            card_mod = copy.deepcopy(module).to(device)
            got = flat_outputs(card_mod(*tree_map(lambda t: t.to(device),
                                                  args)))
        err = 0.0
        for r, o in zip(ref, got):
            scale = float(r.abs().max())
            if scale == 0 or not torch.isfinite(o).all():
                raise AssertionError(f'{name}: a zero or non-finite output')
            err = max(err, float((o[:1].cpu() - r).abs().max()) / scale)
        if len(ref) != len(got) or err > BLOCK_RTOL:
            raise AssertionError(f'{name}: the device\'s float32 output is '
                                 f'{err:.3g} of its largest magnitude off '
                                 f'the host\'s (> {BLOCK_RTOL})')
        for m in card_mod.modules():
            if isinstance(m, WEIGHTED_LAYERS):
                m.to(torch.bfloat16)
        half = tree_map(lambda t: t.to(device, torch.bfloat16), args)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            out = flat_outputs(card_mod(*half))
            if not all(torch.isfinite(o).all() for o in out):
                raise AssertionError(f'{name}: non-finite bfloat16 output')
            ms = time_ms(lambda: card_mod(*half), reps, device)
        peak = torch.cuda.max_memory_allocated() / 2**20 if on_card \
            else float('nan')
        shapes = tree_map(lambda t: tuple(t.shape), args)
        log(f'[blocks] {card} | {name} {shapes}: float32 device vs host '
            f'{err:.3g} of the largest output (<= {BLOCK_RTOL}); bfloat16 '
            f'forward {ms:.3f} ms (CUDA events, {reps} runs), peak memory '
            f'{peak:.0f} MiB')
        records.append(dict(name=name, err=err, ms=ms, peak_mib=peak))
        del card_mod, half, out
    log(f'[blocks] {len(records)} cases in {time.perf_counter() - t0:.1f} '
        f's; worst float32 difference {max(r["err"] for r in records):.3g}')
    return records


def same_test_cfgs(converted, seeded) -> None:
    """The seeded detector's test-time settings (``max_candidates``, the
    proposals an image) on the converted one's modules."""
    import copy
    for name, module in seeded.named_modules():
        cfg = getattr(module, 'test_cfg', None)
        if isinstance(cfg, dict):
            converted.get_submodule(name).test_cfg = copy.deepcopy(cfg)


def phase_reference_weights(device, card='', root=None, bsz=2, size=1024,
                            configs=None, max_num=2000,
                            max_candidates=2000) -> tuple:
    """Phase 52: seeded prototype4 (:func:`build_yolo_bundle`) and ReDet
    (:func:`build_hbb_bundle`) in float32, each state written under the
    reference's names (``utils/reference_weights.py:
    synthesize_reference_state``: the YOLO stack's mmyolo names, ReDet's
    e2cnn filters and per-field BatchNorms) into a ``.pth``, converted by
    ``python -m orientedobjectdetection_torch.tools.convert_reference_
    weights`` in a subprocess (no leftover key) and served by
    ``init_detector(config, converted)``: every tensor equal to the seeded
    model's bit for bit, the detections of ``bsz`` images equal too. The
    launch counts cover both models' requests (B1 in each, B3 in ReDet's).
    ``configs``: label -> config. Returns the counts and the kernels'
    inputs."""
    from orientedobjectdetection_torch.apis import init_detector
    from orientedobjectdetection_torch.models.roi_heads import (
        oriented_roi_head)
    from orientedobjectdetection_torch.ops import nms
    from orientedobjectdetection_torch.utils.reference_weights import \
        synthesize_reference_state
    root = root or os.path.join(DATA_DIR, 'reference')
    os.makedirs(root, exist_ok=True)
    configs = configs or {'prototype4': YOLO_CONFIGS['prototype4'],
                          'redet': REDET_CONFIG}
    builders = {
        'prototype4': ('RotatedYOLOv8', lambda cfg: build_yolo_bundle(
            cfg, device, torch.float32, max_candidates)),
        'redet': ('ReDet', lambda cfg: build_hbb_bundle(
            cfg, device, torch.float32, max_num, max_candidates))}
    images = raw_images(bsz, size, 520)
    runs, captured = [], {}
    for label, config in configs.items():
        kind, build = builders[label]
        seeded = build(config)
        state = {k: v.detach().cpu() for k, v in
                 seeded.detector.state_dict().items()}
        reference = synthesize_reference_state(state, kind)
        src = os.path.join(root, f'{label}_reference.pth')
        out = os.path.join(root, f'{label}_converted.pth')
        torch.save(dict(state_dict={k: torch.from_numpy(v)
                                    for k, v in reference.items()},
                        meta=dict(seed=0)), src)
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, '-m',
             'orientedobjectdetection_torch.tools.convert_reference_weights',
             src, out, '--type', kind], capture_output=True, text=True,
            cwd=ROOT, timeout=600)
        tool_s = time.perf_counter() - t0
        if done.returncode or 'unmapped' in done.stdout:
            raise AssertionError(f'{label}: the converter failed or left '
                                 f'keys: {done.stdout[-2000:]} '
                                 f'{done.stderr[-2000:]}')
        converted = init_detector(seeded.cfg, out, device=device,
                                  dtype=torch.float32,
                                  device_norm=seeded.device_norm)
        same_test_cfgs(converted.detector, seeded.detector)
        got = converted.detector.state_dict()
        if sorted(got) != sorted(state):
            raise AssertionError(f'{label}: the converted model has other '
                                 f'tensors')
        differ = [k for k, v in state.items()
                  if not torch.equal(got[k].cpu(), v)]
        if differ:
            raise AssertionError(f'{label}: {len(differ)} tensors differ '
                                 f'from the seeded model\'s: {differ[:4]}')
        reset_launches()
        with recording(nms, 'nms_pair_mask') as masks, \
                recording(oriented_roi_head, 'roi_align_rotated_pyramid',
                          keep_results=False) as pools:
            ref = seeded(images)
            dets = converted(images)
        sync(device)
        counts = read_launches()
        check_dets(*dets, bsz, converted.num_classes)
        if not all(torch.equal(a, b) for a, b in zip(dets, ref)):
            raise AssertionError(f'{label}: the converted model\'s '
                                 f'detections differ from the seeded '
                                 f'model\'s')
        captured[f'{label}_converted_nms'] = [(args[0], args[2])
                                              for args, _ in masks]
        if pools:
            captured[f'{label}_converted_roi'] = pooled_inputs(pools)
        log(f'[reference-weights] {label}: {len(reference)} reference '
            f'tensors ({os.path.getsize(src) / 2**20:.1f} MiB) converted by '
            f'the tool in {tool_s:.1f} s, no leftover key; all {len(state)} '
            f'tensors of the served model equal the seeded model\'s bit for '
            f'bit; float32 B={bsz} {size}^2 detections equal (valid per '
            f'image {dets[2].sum(1).tolist()}); launches {counts}')
        runs.append(counts)
        del seeded, converted
    return runs, captured


def held_yolov6(device, captured, by_name, card, reps, roi_reps,
                plain_reps) -> None:
    """Phases 50-52's recorded inputs against their plain versions, the
    largest of each kind timed into ``main_path_inputs``: B1 on the
    YOLOv6-neck model's slice and request candidates and on the converted
    models' requests, B2 on its slice's and its trained steps' assigner
    inputs, B3 on the converted ReDet's levels and proposals."""
    pair, iou = by_name['nms_pair_mask'], by_name['box_iou_rotated']
    held_pair_masks(captured['yolov6_slice_nms'], 'YOLOv6-neck float32 '
                    'slice', 'yolov6_slice', pair, device, card, reps,
                    plain_reps)
    held_pair_masks([captured['yolov6']], 'YOLOv6-neck request', 'yolov6',
                    pair, device, card, reps, plain_reps)
    held_iou_matrices(captured['yolov6_slice_assign'], 'YOLOv6-neck float32 '
                      'slice\'s assigner', 'yolov6_slice_assign', iou, device,
                      card, reps, plain_reps)
    held_iou_matrices(captured['yolov6_train'], 'YOLOv6-neck assigner (G=32)',
                      'yolov6_train', iou, device, card, reps, plain_reps)
    held_pair_masks(captured['prototype4_converted_nms'] +
                    captured['redet_converted_nms'], 'converted '
                    'checkpoints\' requests', 'converted', pair, device,
                    card, reps, plain_reps)
    held_roi_inputs(captured['redet_converted_roi'], 'converted ReDet '
                    'request', 'redet_converted', by_name['roi_align_rotated'],
                    device, card, roi_reps, plain_reps)


def phase_main_path_kernels(device, captured, records, card='', reps=50,
                            roi_reps=20, plain_reps=1) -> None:
    """Phases 3, 6 and 9 on the inputs recorded in phases 5, 8, 11, 14 and
    17-46: each kernel against its plain version with the same
    tolerances, then timed beside its bound. Adds ``main_path_inputs`` to
    the kernels' records."""
    by_name = {rec['name']: rec for rec in records}
    HELD_MATRICES.clear()
    pair = by_name['nms_pair_mask']
    pair['main_path_inputs'] = {}
    for key, label in (('retinanet', 'RetinaNet request'),
                       ('orcnn', 'Oriented R-CNN request')):
        boxes, cls = captured[key]
        err, in_band = check_pair_mask(boxes, cls)
        pair['max_abs_err'] = max(pair['max_abs_err'], err)
        log(f'[main-path] nms_pair_mask on the candidates of one {label} '
            f'B={boxes.shape[0]} N={boxes.shape[1]}: equal to plain outside '
            f'+-{BAND} of thr={IOU_THR} ({in_band} in-band differences)')
        pair['main_path_inputs'][key] = time_pair_mask(
            boxes, cls, device, card, f'{label} candidates', reps,
            plain_reps)
    levels, rois = captured['orcnn_roi']
    roi = by_name['roi_align_rotated']
    err = check_roi_align(levels, rois, False, padding=False)
    roi['max_abs_err'] = max(roi['max_abs_err'], err)
    cells, live, per_level = roi_align_work(levels, rois)
    log(f'[main-path] roi_align_rotated on the levels and proposals of one '
        f'Oriented R-CNN request B={rois.shape[0]} R={rois.shape[1]} '
        f'C={levels[0].shape[-1]} {str(levels[0].dtype).split(".")[-1]}: max '
        f'|kernel - plain| {err:.3g}; {live} live RoIs, per level '
        f'{per_level}, {cells} feature cells touched')
    timing = time_roi_align(levels, rois, (cells, live), device, card,
                            'Oriented R-CNN request proposals', roi_reps,
                            plain_reps)
    roi['main_path_inputs'] = {'orcnn': dict(
        timing, live_rois=live, rois_per_level=per_level, cells=cells)}
    boxes1, boxes2, mode = captured['train_step']
    iou = by_name['box_iou_rotated']
    err, live = check_iou_matrix(boxes1, boxes2, mode)
    iou['max_abs_err'] = max(iou['max_abs_err'], err)
    log(f'[main-path] box_iou_rotated on the assigner\'s inputs in one train '
        f'step {tuple(boxes1.shape)} x {tuple(boxes2.shape)} {mode}: max '
        f'|kernel - plain| {err:.3g} <= {IOU_ATOL}; {live} pairs within '
        f'reach, the rest exactly 0')
    iou['main_path_inputs'] = {'train_step': time_iou_matrix(
        boxes1, boxes2, live, device, card, 'train step\'s assigner inputs',
        reps, plain_reps, mode)}
    for key, label in (('orcnn_train_rpn', 'Oriented R-CNN RPN assigner'),
                       ('orcnn_train_roi', 'Oriented R-CNN RoI assigner')):
        boxes1, boxes2, mode = captured[key]
        err, live = check_iou_matrix(boxes1, boxes2, mode)
        iou['max_abs_err'] = max(iou['max_abs_err'], err)
        log(f'[main-path] box_iou_rotated on the {label}\'s inputs in one '
            f'two-stage train step {tuple(boxes1.shape)} x '
            f'{tuple(boxes2.shape)} {mode}: max |kernel - plain| {err:.3g} '
            f'<= {IOU_ATOL}; {live} pairs within reach, the rest exactly 0')
        iou['main_path_inputs'][key] = time_iou_matrix(
            boxes1, boxes2, live, device, card, f'{label} inputs', reps,
            plain_reps, mode)
    held_loops(device, captured, by_name, card, reps, roi_reps, plain_reps)
    held_families(device, captured, by_name, card, reps, plain_reps)
    held_refine(device, captured, by_name, card, reps, plain_reps)
    held_hbb(device, captured, by_name, card, reps, roi_reps, plain_reps)
    held_backbones(device, captured, by_name, card, reps, roi_reps,
                   plain_reps)
    held_reppoints(device, captured, by_name, card, reps, plain_reps)
    held_yolo(device, captured, by_name, card, reps, plain_reps)
    held_yolov6(device, captured, by_name, card, reps, roi_reps, plain_reps)


def matrix_pairs(boxes1, boxes2) -> int:
    batch = max(b.shape[0] if b.dim() == 3 else 1 for b in (boxes1, boxes2))
    return batch * boxes1.shape[-2] * boxes2.shape[-2]


def held_loops(device, captured, by_name, card, reps, roi_reps,
               plain_reps) -> None:
    """Phases 17-22's recorded inputs: every one held against its plain
    version; the largest of each kind timed into ``main_path_inputs``."""
    iou, pair = by_name['box_iou_rotated'], by_name['nms_pair_mask']
    roi = by_name['roi_align_rotated']
    for key, label in (
            ('eval_iou', 'eval_rbbox_map on the synth1024 val set'),
            ('orcnn_loop_rpn', 'tiny Oriented R-CNN loop\'s RPN assigner'),
            ('orcnn_loop_roi', 'tiny Oriented R-CNN loop\'s RoI assigner'),
            ('orcnn_loop_eval_iou', 'eval_rbbox_map in the tiny Oriented '
             'R-CNN loop'),
            ('hrsc_assign', 'HRSC rr training\'s assigner'),
            ('hrsc_train_eval_iou', 'HRSC rr training\'s evaluation'),
            ('hrsc_eval_iou', 'HRSC evaluate (AP50, AP75)')):
        held_iou_matrices(captured[key], label, key, iou, device, card, reps,
                          plain_reps)
    for key, out_key, label in (
            ('orcnn_loop_nms', 'orcnn_loop_eval',
             'tiny Oriented R-CNN loop\'s evaluation'),
            ('patch_merge', 'patch_merge', 'huge-image merge (phase 19)'),
            ('submission_merge', 'submission_merge',
             'submission merge_det (phase 21)')):
        held_pair_masks(captured[key], label, out_key, pair, device, card,
                        reps, plain_reps,
                        rows_for_largest=key != 'orcnn_loop_nms')
    calls = captured['orcnn_loop_roi_align']
    errs = [check_roi_align(levels, rois, False, padding=False)
            for levels, rois in calls]
    roi['max_abs_err'] = max([roi['max_abs_err']] + errs)
    levels, rois = max(calls, key=lambda c: c[1].shape[0] * c[1].shape[1])
    cells, live, per_level = roi_align_work(levels, rois)
    log(f'[main-path] roi_align_rotated on the {len(calls)} inputs of the '
        f'tiny Oriented R-CNN loop\'s evaluation, largest B={rois.shape[0]} '
        f'R={rois.shape[1]} C={levels[0].shape[-1]} '
        f'{str(levels[0].dtype).split(".")[-1]}: max |kernel - plain| '
        f'{max(errs):.3g}; {live} live RoIs, per level {per_level}')
    timing = time_roi_align(levels, rois, (cells, live), device, card,
                            'tiny Oriented R-CNN eval proposals', roi_reps,
                            plain_reps)
    roi['main_path_inputs']['orcnn_loop_eval'] = dict(
        timing, live_rois=live, rois_per_level=per_level, cells=cells,
        inputs_held=len(calls))


# IoU-matrix inputs phase 12 has held, with their check and timing: the
# two-stage detectors' RPN inputs are the same seeded gts against the same
# anchors in every family, bit for bit, and the plain matrix at G=512
# takes seconds
HELD_MATRICES = []


def held_matrix(args, device, card, reps, plain_reps, label) -> dict:
    """:func:`check_iou_matrix` of ``args`` and, where ``label`` is given,
    :func:`time_iou_matrix`, or those of an equal input held before."""
    for old, result in HELD_MATRICES:
        if old[2] == args[2] and all(
                a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(old[:2], args[:2])):
            break
    else:
        result = dict(zip(('err', 'live'), check_iou_matrix(*args)), seen=0)
        HELD_MATRICES.append((args, result))
    result['seen'] += 1
    if label and 'timing' not in result:
        result['timing'] = time_iou_matrix(
            args[0], args[1], result['live'], device, card, label, reps,
            plain_reps, args[2])
    return result


def held_iou_matrices(calls, label, key, iou, device, card, reps,
                      plain_reps) -> None:
    """Every (boxes1, boxes2, mode) of ``calls`` against the plain matrix;
    the largest timed into ``iou['main_path_inputs'][key]``. An input equal
    to one held before takes that one's check and timing."""
    if not calls:
        log(f'[main-path] box_iou_rotated: the {label} gave no input')
        return
    big = max(range(len(calls)), key=lambda i: matrix_pairs(*calls[i][:2]))
    held = [held_matrix(args, device, card, reps, plain_reps,
                        f'{label}\'s largest input' if i == big else None)
            for i, args in enumerate(calls)]
    err = max(h['err'] for h in held)
    iou['max_abs_err'] = max(iou['max_abs_err'], err)
    boxes1, boxes2, mode = calls[big]
    again = sum(h['seen'] > 1 for h in held)
    log(f'[main-path] box_iou_rotated on the {len(calls)} inputs of the '
        f'{label} ({again} equal to inputs held before), largest '
        f'{tuple(boxes1.shape)} x {tuple(boxes2.shape)} {mode}: max |kernel '
        f'- plain| {err:.3g} <= {IOU_ATOL}; out-of-reach pairs exactly 0')
    iou['main_path_inputs'][key] = dict(held[big]['timing'],
                                        inputs_held=len(calls))


def pair_mask_rows(boxes, cls, device, rows=MERGE_ROWS) -> tuple:
    """:func:`check_pair_mask` for an input too large for ``(B, N, N)``
    float arrays: the kernel's mask, then ``rows`` rows of it at a time
    against the plain IoU of those rows and the columns from the first on
    (the plain version's own blocks), exact outside the band, nothing on or
    below the diagonal. Returns (in-band differences, same-class pairs,
    those in reach, the plain blocks' ms)."""
    from orientedobjectdetection_torch.ops.iou import box_iou_rotated
    from orientedobjectdetection_torch.ops.iou_kernels import (
        nms_pair_mask, pairs_in_reach)
    got = nms_pair_mask(boxes, IOU_THR, cls)
    n = boxes.shape[1]
    idx = torch.arange(n, device=boxes.device)
    in_band = same_pairs = in_reach = 0
    plain_s = 0.0
    for r in range(0, n, rows):
        block, cols = boxes[:, r:r + rows], boxes[:, r:]
        sync(device)
        t0 = time.perf_counter()
        iou = box_iou_rotated(block, cols)
        same = cls[:, r:r + rows, None] == cls[:, None, r:]
        upper = idx[r:r + rows, None] < idx[None, r:]
        ref = (iou > IOU_THR) & same & upper
        sync(device)
        plain_s += time.perf_counter() - t0
        mine = got[:, r:r + rows, r:].bool()
        differ = mine != ref
        band = (iou - IOU_THR).abs() < BAND
        if (differ & ~band).any() or (mine & ~upper).any() or \
                got[:, r:r + rows, :r].any():
            raise AssertionError(f'pair mask rows {r}-{r + rows} differ '
                                 f'from the plain version outside the band')
        in_band += int((differ & band).sum())
        same &= upper
        same_pairs += int(same.sum())
        in_reach += int((same & pairs_in_reach(block, cols)).sum())
    return in_band, same_pairs, in_reach, plain_s * 1e3


def held_pair_masks(calls, label, key, pair, device, card, reps,
                    plain_reps, rows_for_largest=False) -> None:
    """Every (boxes, class ids) of ``calls`` against the plain pair mask,
    in row blocks from ``BIG_N`` on (and the largest in any case with
    ``rows_for_largest``: a merge's); the largest timed into
    ``pair['main_path_inputs'][key]`` (held in row blocks: the kernel over
    3 launches, the plain version as the sum of its row blocks)."""
    if not calls:
        raise AssertionError(f'the {label} gave no pair-mask input')
    largest = max(range(len(calls)), key=lambda k: calls[k][0].shape[1])
    by_rows = [k == largest and rows_for_largest or
               calls[k][0].shape[1] >= BIG_N for k in range(len(calls))]
    small = [c for c, rows in zip(calls, by_rows) if not rows]
    big = [c for c, rows in zip(calls, by_rows) if rows]
    held = [check_pair_mask(boxes, cls) for boxes, cls in small]
    pair['max_abs_err'] = max([pair['max_abs_err']] +
                              [err for err, _ in held])
    rows = [pair_mask_rows(boxes, cls, device) for boxes, cls in big]
    in_band = sum(n for _, n in held) + sum(r[0] for r in rows)
    ns = sorted(boxes.shape[1] for boxes, _ in calls)
    log(f'[main-path] nms_pair_mask on the {len(calls)} inputs of the '
        f'{label}, N {ns[0]}-{ns[-1]} ({len(big)} of them, the largest '
        f'{"among them" if by_rows[largest] else "not"}, held in blocks of '
        f'{MERGE_ROWS} rows): equal to plain outside +-{BAND} of '
        f'thr={IOU_THR} ({in_band} in-band differences)')
    if not big:
        boxes, cls = max(calls, key=lambda c: c[0].shape[0] * c[0].shape[1])
        timing = time_pair_mask(boxes, cls, device, card,
                                f'{label}\'s largest input', reps,
                                plain_reps)
    else:
        from orientedobjectdetection_torch.ops.iou_kernels import \
            nms_pair_mask
        i = max(range(len(big)), key=lambda k: big[k][0].shape[1])
        (boxes, cls), (_, same, reach, plain_ms) = big[i], rows[i]
        n = boxes.shape[1]
        ms = time_ms(lambda: nms_pair_mask(boxes, IOU_THR, cls), 3, device,
                     warmup=1)
        t_bytes = (boxes.numel() * 4 + cls.numel() * 4 +
                   boxes.shape[0] * n * n) / PEAK_BYTES * 1e3
        t_ops = reach * FLOP_PER_PAIR / PEAK_FP32 * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = 'bytes' if t_bytes >= t_ops else 'operations'
        log(f'[kernel] {card} | nms_pair_mask {label}\'s largest input '
            f'B={boxes.shape[0]} N={n}: kernel {ms:.4f} ms, plain '
            f'{plain_ms:.3f} ms (its row blocks), bound {bound_ms:.4f} ms '
            f'({bound_by}; {same} same-class pairs, {reach} of them in '
            f'reach), library none')
        timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, same_class_pairs=same,
                      pairs_in_reach=reach)
    pair['main_path_inputs'][key] = dict(timing, inputs_held=len(calls),
                                         largest_n=ns[-1])


def main() -> int:
    info = phase_device()
    # float32 comparisons run in full float32 (no TF32 in cuDNN or cuBLAS)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    records = [phase_kernel('cuda', card=info['card'])]
    phase_slice('cuda')
    serving, captured = phase_serving('cuda', card=info['card'])
    records.append(phase_iou_kernel('cuda', card=info['card']))
    phase_train_slice('cuda')
    training, train_inputs = phase_training('cuda', card=info['card'])
    captured.update(train_inputs)
    records.append(phase_roi_kernel('cuda', card=info['card']))
    phase_orcnn_slice('cuda')
    orcnn, orcnn_inputs = phase_orcnn_serving('cuda', card=info['card'])
    captured.update(orcnn_inputs)
    phase_orcnn_train_slice('cuda')
    orcnn_train8, orcnn_train_inputs = phase_orcnn_training(
        'cuda', card=info['card'], bsz=8)
    captured.update(orcnn_train_inputs)
    orcnn_train4 = phase_orcnn_training('cuda', card=info['card'], bsz=4,
                                        record=False)[0]
    hard = os.path.join(DATA_DIR, 'synth_hard1024')
    t15 = time.perf_counter()
    phase_data(hard, card=info['card'])
    trainer, trained = phase_trainer(
        hard, os.path.join(DATA_DIR, 'work_synth1024'), card=info['card'],
        synthetic_rate=captured['training_imgs_per_s'])
    evaluator, eval_inputs = phase_evaluator(hard, trained,
                                             card=info['card'])
    captured.update(eval_inputs)
    orcnn_loop, loop_inputs = phase_orcnn_loop(
        os.path.join(DATA_DIR, 'synth_tiny'),
        os.path.join(DATA_DIR, 'work_orcnn_tiny'), card=info['card'])
    captured.update(loop_inputs)
    log(f'[phases 15-18] {time.perf_counter() - t15:.1f} s')
    t19 = time.perf_counter()
    patches, patch_inputs = phase_patches('cuda', card=info['card'])
    captured.update(patch_inputs)
    tta = phase_tta('cuda', card=info['card'])
    submission, submission_inputs = phase_submission(
        os.path.join(DATA_DIR, 'submission'), trained, card=info['card'])
    captured.update(submission_inputs)
    augment, augment_inputs = phase_augment(
        os.path.join(DATA_DIR, 'synth_hrsc1024'),
        os.path.join(DATA_DIR, 'work_hrsc_rr'), card=info['card'])
    captured.update(augment_inputs)
    log(f'[phases 19-22] {time.perf_counter() - t19:.1f} s')
    t23 = time.perf_counter()
    fcos, fcos_inputs = phase_fcos('cuda', card=info['card'])
    captured.update(fcos_inputs)
    families, family_inputs = phase_anchor_families('cuda', card=info['card'])
    captured.update(family_inputs)
    loops, loop_inputs = phase_family_loops(
        os.path.join(DATA_DIR, 'synth_tiny'),
        os.path.join(DATA_DIR, 'work_families'), card=info['card'])
    captured.update(loop_inputs)
    log(f'[phases 23-26] {time.perf_counter() - t23:.1f} s')
    t27 = time.perf_counter()
    captured.update(phase_refine_slice('cuda'))
    refine_serving, refine_inputs = phase_refine_serving('cuda',
                                                         card=info['card'])
    captured.update(refine_inputs)
    refine_training, refine_inputs = phase_refine_training(
        'cuda', card=info['card'])
    captured.update(refine_inputs)
    refine_loops, loop_inputs = phase_refine_loops(
        os.path.join(DATA_DIR, 'synth_tiny'),
        os.path.join(DATA_DIR, 'work_refine'), card=info['card'])
    captured.update(loop_inputs)
    log(f'[phases 27-30] {time.perf_counter() - t27:.1f} s')
    t31 = time.perf_counter()
    captured.update(phase_hbb_slice('cuda'))
    hbb_serving, hbb_inputs = phase_hbb_serving('cuda', card=info['card'])
    captured.update(hbb_inputs)
    hbb_training, hbb_inputs = phase_hbb_training('cuda', card=info['card'])
    captured.update(hbb_inputs)
    hbb_loops, loop_inputs = phase_hbb_loops(
        os.path.join(DATA_DIR, 'synth_tiny'),
        os.path.join(DATA_DIR, 'work_hbb'), card=info['card'])
    captured.update(loop_inputs)
    log(f'[phases 31-34] {time.perf_counter() - t31:.1f} s')
    t35 = time.perf_counter()
    captured.update(phase_backbone_slice('cuda'))
    backbone_serving, backbone_inputs = phase_backbone_serving(
        'cuda', card=info['card'])
    captured.update(backbone_inputs)
    backbone_training, backbone_inputs = phase_backbone_training(
        'cuda', card=info['card'])
    captured.update(backbone_inputs)
    redet_loop, loop_inputs = phase_redet_loop(
        os.path.join(DATA_DIR, 'synth_tiny'),
        os.path.join(DATA_DIR, 'work_redet'), card=info['card'])
    captured.update(loop_inputs)
    log(f'[phases 35-38] {time.perf_counter() - t35:.1f} s')
    t39 = time.perf_counter()
    captured.update(phase_reppoints_slice('cuda'))
    reppoints_serving, reppoints_inputs = phase_reppoints_serving(
        'cuda', card=info['card'])
    captured.update(reppoints_inputs)
    reppoints_training, reppoints_inputs = phase_reppoints_training(
        'cuda', card=info['card'])
    captured.update(reppoints_inputs)
    reppoints_loops, loop_inputs = phase_reppoints_loops(
        os.path.join(DATA_DIR, 'synth_tiny'),
        os.path.join(DATA_DIR, 'work_reppoints'), card=info['card'])
    captured.update(loop_inputs)
    log(f'[phases 39-42] {time.perf_counter() - t39:.1f} s')
    t43 = time.perf_counter()
    captured.update(phase_yolo_slice('cuda'))
    yolo_serving, yolo_inputs = phase_yolo_serving('cuda', card=info['card'])
    captured.update(yolo_inputs)
    yolo_training, yolo_inputs = phase_yolo_training('cuda',
                                                     card=info['card'])
    captured.update(yolo_inputs)
    yolo_loop, loop_inputs = phase_yolo_loop(
        os.path.join(DATA_DIR, 'synth_tiny'),
        os.path.join(DATA_DIR, 'work_yolov8'), card=info['card'])
    captured.update(loop_inputs)
    log(f'[phases 43-46] {time.perf_counter() - t43:.1f} s')
    t47 = time.perf_counter()
    served = os.path.join(DATA_DIR, 'synth1024_trained.pth')
    torch.save(zero_class_bias(trained), served)
    dp_runs = phase_data_parallel('cuda', card=info['card'], eval_sets={
        'retinanet': (SYNTH1024_CONFIG, hard, served),
        'orcnn': (ORCNN_TINY_CONFIG, os.path.join(DATA_DIR, 'synth_tiny'),
                  os.path.join(DATA_DIR, 'work_orcnn_tiny',
                               'ckpt_00000020.pth'))})
    host_runs = phase_host(hard, trained, captured, card=info['card'])
    log(f'[phases 47-49] {time.perf_counter() - t47:.1f} s')
    t50 = time.perf_counter()
    v6_config = yolov6_config()
    captured.update(phase_yolov6_slice('cuda', v6_config))
    yolov6_runs, yolov6_inputs = phase_yolov6('cuda', card=info['card'],
                                              config=v6_config)
    captured.update(yolov6_inputs)
    log(f'[phase 50] {time.perf_counter() - t50:.1f} s')
    t51 = time.perf_counter()
    phase_blocks('cuda', card=info['card'])
    log(f'[phase 51] {time.perf_counter() - t51:.1f} s')
    t52 = time.perf_counter()
    reference_runs, reference_inputs = phase_reference_weights(
        'cuda', card=info['card'])
    captured.update(reference_inputs)
    log(f'[phase 52] {time.perf_counter() - t52:.1f} s')
    phase_main_path_kernels('cuda', captured, records, card=info['card'])
    for rec in records:
        # launches on the main paths: RetinaNet serving's requests and
        # training's steps, Oriented R-CNN serving's requests and training's
        # steps at batch 8 and 4, the trainer's run with its evaluation,
        # the evaluator's run, the two-stage trainer's run, the huge image,
        # the flips, the submission's evaluations and merges, the HRSC run
        # with its evaluation, FCOS serving and training, the anchor
        # recipes' training and serving, the tiny FCOS and CSL runs with
        # their evaluations, S2ANet's and R3Det's requests and steps, and
        # their tiny runs with their evaluations, and the same for Rotated
        # Faster R-CNN, Gliding Vertex and RoI Transformer, and for the
        # Swin, ConvNeXt and ReDet detectors (ReDet's tiny run), the
        # point-set families' requests, steps and tiny runs, and the YOLOv8
        # models' requests, prototype4's steps (frozen and live BN) and the
        # tiny YOLOv8 run, the data-parallel steps and evaluations of each
        # rank, the served requests, the host NMS check's kernel calls and
        # the confusion matrix, the YOLOv6-neck model's requests and steps,
        # and the seeded and converted models' requests of phase 52
        rec['launches'] = sum(run[rec['name']] for run in (
            serving, training, orcnn, orcnn_train8, orcnn_train4, trainer,
            evaluator, orcnn_loop, patches, tta, submission, augment,
            *fcos, *families, *loops, *refine_serving, *refine_training,
            *refine_loops, *hbb_serving, *hbb_training, *hbb_loops,
            *backbone_serving, *backbone_training, *redet_loop,
            *reppoints_serving, *reppoints_training, *reppoints_loops,
            *yolo_serving, *yolo_training, *yolo_loop, *dp_runs,
            *host_runs, *yolov6_runs, *reference_runs))
        if rec['launches'] < 1:
            raise AssertionError(f'{rec["name"]} never ran on a main path')
    log(f'[done] {time.perf_counter() - t0:.1f} s on {info["card"]}')
    print(json.dumps({'kernels': records}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': info['kind'], 'count': info['count']}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
