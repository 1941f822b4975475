"""The GMD evaluation step.

Counterpart of ``make_gmd_test_step`` in
``shufflingvideosfortsg_tpu/train/steps.py:301-351`` (the ungrouped,
top-1 form): ``eval_forward``, the grounding NLL, the span decode and
per-sample IoU. The train steps arrive with the training slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ..ops.losses import span_ground_nll
from ..ops.span import iou_per_sample, span_decode

# batch keys the step reads, moved to the device per batch
STEP_KEYS = ('video_feat', 'sent_feat', 'video_mask', 'sent_mask',
             'framestps', 'timestps', 'nfeats', 'duration')


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device)
            for k in STEP_KEYS}


def make_gmd_test_step(model, lg_frame2sec: bool = False
                       ) -> Callable[[Dict[str, torch.Tensor]],
                                     Dict[str, torch.Tensor]]:
    """Returns step(batch) -> {loss, miou, pred_time [B, 2], score [B]} on
    the batch's device. loss and miou average over all B rows, padded
    wrap-around rows included, as the JAX step does."""

    @torch.no_grad()
    def test_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = model.eval_forward(batch['video_feat'], batch['sent_feat'],
                                 batch['video_mask'], batch['sent_mask'])
        nll = span_ground_nll(out['start_prob'], out['end_prob'],
                              batch['framestps'])
        pred, score = span_decode(out['start_prob'], out['end_prob'])
        pred_f = pred.float()
        if lg_frame2sec:
            pred_f = pred_f / batch['nfeats'][:, None].float() \
                * batch['duration'][:, None].float()
        iou = iou_per_sample(pred_f, batch['timestps'])
        return {'loss': nll.mean(), 'miou': iou.mean(), 'pred_time': pred_f,
                'score': score}

    return test_step
