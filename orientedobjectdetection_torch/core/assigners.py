"""Label assignment and sampling, batched over images and padded
(counterpart of ``orientedobjectdetection_tpu/core/assigners.py``:
``AssignResult``, ``MaxIoUAssigner``, ``random_sample_masks``,
``rng_from_gt``, ``SamplingResult``, ``PseudoSampler`` and
``RRandomSampler``).

The assigner takes a padded gt set per image (``gt_bboxes (B, G, 5)``,
``gt_labels (B, G)``, ``gt_mask (B, G)``) and the priors, anchors shared by
the batch or proposals of each image, and returns per-prior results of
fixed shape. Everything stays on the inputs' device with no data-dependent
shape (no ``nonzero``, no boolean indexing), so a train step never waits
for the host. The whole batch is one call: one IoU matrix ``(B, G, N)``,
one kernel launch on the card.

Output convention (``AssignResult``), each ``(B, N)``:
    assigned_gt_inds: int64, index into the gt axis; -1 = negative,
        -2 = ignore (between the thresholds or inside an ignore region).
    max_overlaps: float32.
    labels: int64, class of the assigned gt; -1 where not positive.

Sampling keeps at most ``num * pos_fraction`` positives chosen at random
and fills up to ``num`` with random negatives (mmdet's ``RandomSampler``),
with masks in place of index sets. The candidates are ranked by one uniform
number each, in a stable descending order: the lowest index wins a tie.
Ties are real, since a float32 uniform takes 2^23 values.

Random numbers. The JAX package derives ``jax.random`` keys (threefry),
whose bits the port cannot reproduce. A :class:`SampleKey` records how the
JAX key of the same draw is derived, and every uniform number of the port
comes through one function, :func:`uniform`, which hashes that derivation
on the device (no host round trip). The parity tests replace
:func:`uniform` with one that returns the JAX package's draws for the same
keys.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.boxes import obb2hbb
from ..ops.iou import rbbox_overlaps
from ..utils.registry import BBOX_ASSIGNERS

NEG = -1
IGNORE = -2


class AssignResult(NamedTuple):
    assigned_gt_inds: torch.Tensor   # >= 0 gt index, -1 negative, -2 ignore
    max_overlaps: torch.Tensor
    labels: torch.Tensor             # -1 if not positive


@BBOX_ASSIGNERS.register_module()
class MaxIoUAssigner:
    """Max-IoU assignment with mmdet's tie-breaking:

    1. a prior is negative if its max IoU < ``neg_iou_thr`` (or inside the
       ``(lo, hi)`` range when that is a pair), ignored if between the
       thresholds;
    2. a prior with max IoU >= ``pos_iou_thr`` is positive to its argmax gt
       (lowest index on a tie);
    3. ``match_low_quality``: each gt claims ALL priors whose IoU with it
       equals the gt's max IoU (``gt_max_assign_all``; else only the first
       such prior) if that max >= ``min_pos_iou``; the highest claiming gt
       index wins a prior, as gts applied in order with overwrite;
    4. ``ignore_iof_thr`` > 0 with ignore boxes: a prior whose IoF with a
       valid ignore box exceeds it is ignored.

    ``assign_by_circumhbbox``: assign on the gts' circumscribed horizontal
    boxes (an angle-version string). ``plain_iou`` computes the matrices
    with the plain PyTorch version on any device (a reference run on the
    card)."""

    def __init__(self,
                 pos_iou_thr: float,
                 neg_iou_thr,
                 min_pos_iou: float = 0.0,
                 gt_max_assign_all: bool = True,
                 ignore_iof_thr: float = -1,
                 match_low_quality: bool = True,
                 assign_by_circumhbbox: Optional[str] = None,
                 iou_calculator: Optional[dict] = None,
                 plain_iou: bool = False):
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.gt_max_assign_all = gt_max_assign_all
        self.ignore_iof_thr = ignore_iof_thr
        self.match_low_quality = match_low_quality
        self.assign_by_circumhbbox = assign_by_circumhbbox
        self.plain_iou = plain_iou

    @torch.no_grad()
    def __call__(self, priors, gt_bboxes, gt_labels, gt_mask,
                 gt_bboxes_ignore=None, gt_ignore_mask=None) -> AssignResult:
        """priors (N, 5) shared by the batch or (B, N, 5) per image;
        gt_bboxes (B, G, 5); gt_labels (B, G); gt_mask (B, G) bool;
        optional gt_bboxes_ignore (B, K, 5) with gt_ignore_mask (B, K). A
        single image may come without the batch axis and gets its results
        without it."""
        if gt_bboxes.dim() == 2:
            single = self(
                priors, gt_bboxes[None], gt_labels[None], gt_mask[None],
                None if gt_bboxes_ignore is None else gt_bboxes_ignore[None],
                None if gt_ignore_mask is None else gt_ignore_mask[None])
            return AssignResult(*(t[0] for t in single))

        gt_for_iou = gt_bboxes
        if self.assign_by_circumhbbox is not None:
            gt_for_iou = obb2hbb(gt_bboxes, self.assign_by_circumhbbox)
        overlaps = rbbox_overlaps(gt_for_iou, priors,
                                  plain=self.plain_iou)        # (B, G, N)
        # Padded gts contribute 0: with no valid gt every prior has max
        # overlap 0 and is a negative. In place: the matrix is ours.
        overlaps.masked_fill_(~gt_mask[:, :, None], 0.0)

        max_overlaps, argmax_overlaps = overlaps.max(dim=1)    # (B, N)
        if isinstance(self.neg_iou_thr, (tuple, list)):
            lo, hi = self.neg_iou_thr
            is_neg = (max_overlaps >= lo) & (max_overlaps < hi)
        else:
            is_neg = max_overlaps < self.neg_iou_thr
        is_pos = max_overlaps >= self.pos_iou_thr

        assigned = torch.full_like(argmax_overlaps, IGNORE)
        assigned = torch.where(is_neg, NEG, assigned)
        assigned = torch.where(is_pos, argmax_overlaps, assigned)

        if self.match_low_quality:
            # row maxima and the equality test come from the same matrix
            gt_max, best = overlaps.max(dim=2)                 # (B, G)
            may_claim = (gt_max >= self.min_pos_iou) & gt_mask
            if self.gt_max_assign_all:
                claim = (overlaps == gt_max[:, :, None]) & \
                    may_claim[:, :, None]                      # (B, G, N)
            else:
                claim = torch.zeros_like(overlaps, dtype=torch.bool)
                claim.scatter_(2, best[:, :, None], may_claim[:, :, None])
            # the last gt to claim a prior wins: highest claiming index
            gt_idx = torch.arange(overlaps.shape[1], dtype=torch.int32,
                                  device=overlaps.device)[None, :, None]
            claimed_idx = torch.where(claim, gt_idx, -1).amax(1).long()
            assigned = torch.where(claimed_idx >= 0, claimed_idx, assigned)

        if self.ignore_iof_thr > 0 and gt_bboxes_ignore is not None:
            iof = rbbox_overlaps(priors, gt_bboxes_ignore, mode='iof',
                                 plain=self.plain_iou)         # (B, N, K)
            iof = torch.where(gt_ignore_mask[:, None, :], iof, -1.0)
            ignore_hit = iof.amax(2) > self.ignore_iof_thr
            assigned = torch.where(ignore_hit, IGNORE, assigned)

        labels = torch.where(
            assigned >= 0,
            gt_labels.long().gather(1, assigned.clamp(min=0)), -1)
        return AssignResult(assigned, max_overlaps, labels)


# ---- random numbers ---------------------------------------------------------
class SampleKey(NamedTuple):
    """The derivation of a batch's ``jax.random`` keys, one per image.

    The root is ``rng_from_gt(gt_bboxes[b])`` for image b when ``gt_bboxes``
    (B, G, 5) is set, else ``fold_in(PRNGKey(0), step)``, shared by the
    batch. Then each ``(n, i)`` of ``path`` takes ``split(key, n)[i]``; an
    ``i`` of None takes ``split(key, n)[b]`` for image b (``n`` is then the
    batch size)."""
    step: int = 0
    gt_bboxes: Optional[torch.Tensor] = None
    path: Tuple[Tuple[int, Optional[int]], ...] = ()

    def split(self, n: int = 2, i: Optional[int] = None) -> 'SampleKey':
        return self._replace(path=self.path + ((n, i),))

    def batch_size(self) -> int:
        if self.gt_bboxes is not None:
            return self.gt_bboxes.shape[0]
        per_image = [n for n, i in self.path if i is None]
        if not per_image:
            raise ValueError('the key is shared by the batch: split it per '
                             'image first (split(batch_size))')
        return per_image[0]


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """Low 32 bits of ``x * c`` for x in [0, 2^32) (an int64 tensor or an
    int), with no intermediate above 2^49."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash (``lowbias32``) of x in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gt_seed(gt_bboxes: torch.Tensor) -> torch.Tensor:
    """(B, G, 5) -> (B,) int64 on their device: ``|sum(gt * 997)| mod
    2^31``, truncated, as JAX ``rng_from_gt`` folds it. The float32 products
    are summed exactly (in float64) and rounded once; the order of XLA's
    float32 sum is not specified, so where that sum is inexact the two
    seeds may differ by its rounding."""
    folded = (gt_bboxes.float() * 997.0).double().sum((-2, -1)).float()
    return torch.fmod(folded.abs(), 2.0 ** 31).long()


def _key_words(key: SampleKey, device) -> torch.Tensor:
    """(B,) int64 words in [0, 2^32), one per image, that stand for the
    image's key."""
    batch = key.batch_size()
    if key.gt_bboxes is not None:
        words = _mix32(gt_seed(key.gt_bboxes).to(device) ^ 0x2545F491)
    else:
        words = torch.full((batch,), _mix32((key.step & _M32) ^ 0x9E3779B9),
                           dtype=torch.int64, device=device)
    for n, i in key.path:
        index = torch.arange(batch, device=device) if i is None else i
        words = _mix32(words ^ _mix32((n << 16 ^ index) & _M32))
    return words


def uniform(key: SampleKey, n: int, device) -> torch.Tensor:
    """(B, n) float32 uniforms in [0, 1), multiples of 2^-23 as
    ``jax.random.uniform``'s, for the images of ``key``: a counter hash of
    the key's words, computed on ``device``. Every random number of the
    port's samplers comes from here."""
    words = _key_words(key, device)[:, None]
    counter = torch.arange(n, dtype=torch.int64, device=device)[None]
    bits = _mix32(_mix32(counter ^ words) ^ _mul32(words, 0x85EBCA6B))
    return (bits >> 9).float() * 2.0 ** -23


def rng_from_gt(gt_bboxes: torch.Tensor) -> SampleKey:
    """Per-image keys folded from the gt content (JAX ``rng_from_gt``):
    distinct images sample distinct priors, and the train step stays a
    pure function of its inputs."""
    return SampleKey(gt_bboxes=gt_bboxes)


# ---- sampling ---------------------------------------------------------------
def sample_scores(pos: torch.Tensor, neg: torch.Tensor, key: SampleKey):
    """One uniform per prior for the positives (``key.split(2, 0)``) and
    one for the negatives (``key.split(2, 1)``), -1 elsewhere: JAX's
    ``k1, k2 = split(rng)``."""
    n = pos.shape[-1]
    pos_scores = torch.where(pos, uniform(key.split(2, 0), n, pos.device),
                             -1.0)
    neg_scores = torch.where(neg, uniform(key.split(2, 1), n, neg.device),
                             -1.0)
    return pos_scores, neg_scores


def keep_ranked(scores: torch.Tensor, limit) -> torch.Tensor:
    """(B, N) scores (candidates >= 0, others -1) -> the candidates whose
    rank in a stable descending order of ``scores`` is below ``limit`` (an
    int or a (B,) tensor): JAX's ``argsort(argsort(-scores)) < limit``."""
    order = torch.sort(-scores, dim=-1, stable=True).indices
    rank = torch.arange(scores.shape[-1], device=scores.device)
    if isinstance(limit, torch.Tensor):
        limit = limit[:, None]
    below = (rank < limit).expand_as(order)
    return torch.empty_like(below).scatter_(-1, order, below) & (scores >= 0)


def masks_from_scores(pos_scores, neg_scores, num: int, pos_fraction: float,
                      neg_pos_ub: int = -1):
    """The sampled masks for given scores (:func:`sample_scores`)."""
    num_pos_max = int(num * pos_fraction)
    pos_keep = keep_ranked(pos_scores, num_pos_max)
    num_pos = torch.clamp((pos_scores >= 0).sum(-1), max=num_pos_max)
    num_neg = num - num_pos
    if neg_pos_ub >= 0:
        num_neg = torch.minimum(num_neg,
                                neg_pos_ub * torch.clamp(num_pos, min=1))
    return pos_keep, keep_ranked(neg_scores, num_neg)


def random_sample_masks(pos: torch.Tensor, neg: torch.Tensor, num: int,
                        pos_fraction: float, key: SampleKey,
                        neg_pos_ub: int = -1):
    """Mask-based random sampling (mmdet ``RandomSampler`` semantics, static
    shapes), per image of (B, N) masks: keep at most ``num * pos_fraction``
    positives at random, then random negatives up to ``num`` (capped at
    ``neg_pos_ub`` times the positives when that is >= 0). Returns
    ``(pos_keep, neg_keep)``."""
    return masks_from_scores(*sample_scores(pos, neg, key), num,
                             pos_fraction, neg_pos_ub)


class SamplingResult(NamedTuple):
    """Masks in place of mmdet's sampled index sets, each (B, N)."""
    pos_mask: torch.Tensor
    neg_mask: torch.Tensor
    assigned_gt_inds: torch.Tensor
    labels: torch.Tensor


@BBOX_ASSIGNERS.register_module()
class PseudoSampler:
    """Every positive and every negative (mmdet ``PseudoSampler``)."""

    def __call__(self, assign_result: AssignResult) -> SamplingResult:
        inds = assign_result.assigned_gt_inds
        return SamplingResult(inds >= 0, inds == NEG, inds,
                              assign_result.labels)


@BBOX_ASSIGNERS.register_module()
class RRandomSampler:
    """Random sampling of positives and negatives (reference
    ``samplers/rotate_random_sampler.py``) by :func:`random_sample_masks`.
    ``add_gt_as_proposals`` is read by the RoI head that adds them."""

    def __init__(self, num: int, pos_fraction: float,
                 neg_pos_ub: int = -1, add_gt_as_proposals: bool = True):
        self.num = num
        self.pos_fraction = pos_fraction
        self.neg_pos_ub = neg_pos_ub
        self.add_gt_as_proposals = add_gt_as_proposals

    def __call__(self, assign_result: AssignResult,
                 rng: SampleKey) -> SamplingResult:
        inds = assign_result.assigned_gt_inds
        pos_keep, neg_keep = random_sample_masks(
            inds >= 0, inds == NEG, self.num, self.pos_fraction, rng,
            neg_pos_ub=self.neg_pos_ub)
        return SamplingResult(pos_keep, neg_keep, inds, assign_result.labels)
