"""Retrieval metrics: R@1 at tIoU thresholds + mean top-1 IoU.

The port's own copy of ``shufflingvideosfortsg_tpu/eval/iou.py``.

Produces the same numbers and the same stdout table as the reference
evaluator (reference: grounding/IoU_eval.py:94-153), from the same
prediction-JSON schema (written at grounding/test.py:88-142):

    {"version": ..., "results": {vid: [{"sentence", "timestamp",
     "gt_timestamp", "score", "video_duration"}, ...]}, "external_data": ...}

Implementation is fresh, vectorized NumPy (no pandas): every (vid, idx)
pair is one sentence sample; R@1 counts strict ``iou > threshold``
(IoU_eval.py:138); IoU uses the +1e-4 union denominator (IoU_eval.py:33).
One intentional divergence: the reference accumulates positives into
``np.empty`` (IoU_eval.py:133) and relies on fresh pages being zero — we
use ``np.zeros``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

PRED_FIELDS = ("results", "version", "external_data")
TIOU_THRESHOLDS = (0.1, 0.3, 0.5, 0.7, 0.9)


def segment_iou(target_segment: np.ndarray, candidate_segments: np.ndarray) -> np.ndarray:
    """Temporal IoU of one [s, e] target against N candidate [s, e] rows.

    Matches reference semantics (IoU_eval.py:8-34): non-negative
    intersection, union with +1e-4 stabilizer.
    """
    tt1 = np.maximum(target_segment[0], candidate_segments[:, 0])
    tt2 = np.minimum(target_segment[1], candidate_segments[:, 1])
    inter = (tt2 - tt1).clip(0)
    union = ((candidate_segments[:, 1] - candidate_segments[:, 0])
             + (target_segment[1] - target_segment[0]) - inter)
    return inter.astype(float) / (union + 1e-4)


def batched_segment_iou(targets: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    """Elementwise IoU of aligned [N,2] target and [N,2] candidate arrays."""
    tt1 = np.maximum(targets[:, 0], candidates[:, 0])
    tt2 = np.minimum(targets[:, 1], candidates[:, 1])
    inter = (tt2 - tt1).clip(0)
    union = ((candidates[:, 1] - candidates[:, 0])
             + (targets[:, 1] - targets[:, 0]) - inter)
    return inter.astype(float) / (union + 1e-4)


def _collect(pred_dict: dict) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten the results dict into aligned gt / prediction [N,2] arrays.

    Ordering is the insertion order of the results dict (which is also the
    order the reference's pandas path iterates), though no metric below
    depends on it.
    """
    gts: List[Sequence[float]] = []
    preds: List[Sequence[float]] = []
    for _vid, entries in pred_dict["results"].items():
        for result in entries:
            gts.append(result["gt_timestamp"][:2])
            preds.append(result["timestamp"][:2])
    return np.asarray(gts, dtype=float), np.asarray(preds, dtype=float)


def _collect_topk(pred_dict: dict) -> Tuple[np.ndarray, np.ndarray, int]:
    """Aligned gt [N,2] and ragged top-k proposals padded to [N,K,2].

    Entries with fewer than K proposals (NMS exhausted the pool) repeat
    their last proposal, which leaves every max-over-first-r metric
    unchanged. Returns K=0 when no entry carries proposals.
    """
    gts: List[Sequence[float]] = []
    topks: List[List[Sequence[float]]] = []
    for _vid, entries in pred_dict["results"].items():
        for result in entries:
            gts.append(result["gt_timestamp"][:2])
            tk = result.get("timestamps_topk")
            topks.append([t[:2] for t in tk] if tk else
                         [result["timestamp"][:2]])
    K = max(len(t) for t in topks) if topks else 0
    if K <= 1:
        return np.asarray(gts, dtype=float), np.zeros((0, 0, 2)), 0
    padded = [t + [t[-1]] * (K - len(t)) for t in topks]
    return (np.asarray(gts, dtype=float),
            np.asarray(padded, dtype=float), K)


def evaluate_topk(pred_dict: dict,
                  tiou_thresholds: Sequence[float] = TIOU_THRESHOLDS
                  ) -> Dict[int, Dict[str, float]]:
    """R@k rows from a prediction dict whose entries carry
    ``timestamps_topk`` (written by the test drivers under
    ``--eval_topk K``). Beyond-parity: the reference evaluates R@1 only.

    For each rank r: ``R{r}@t`` counts sentences where ANY of the first r
    proposals clears ``iou > t``; ``mIoU`` is the mean best IoU over the
    first r proposals ("oracle" mIoU). Rank 1 equals the standard table
    when proposal 1 is the argmax span (NMS keeps it first).
    Returns {rank: {mIoU, R@t..., recall_fractions}} or {} if no entry
    has proposals.
    """
    gts, topk, K = _collect_topk(pred_dict)
    if not K:
        return {}
    ious = np.stack([batched_segment_iou(gts, topk[:, r]) for r in range(K)],
                    axis=1)  # [N, K]
    best = np.maximum.accumulate(ious, axis=1)  # best IoU over first r
    total = len(gts)
    out: Dict[int, Dict[str, float]] = {}
    for r in range(1, K + 1):
        row: Dict[str, float] = {}
        fracs = []
        for t in tiou_thresholds:
            frac = float(np.count_nonzero(best[:, r - 1] > t)) / total
            fracs.append(frac)
            row[f"R{r}@{t}"] = round(frac * 100, 2)
        row["mIoU"] = round(float(best[:, r - 1].mean()) * 100, 2)
        row["recall_fractions"] = fracs  # type: ignore[assignment]
        out[r] = row
    return out


def evaluate_predictions(pred_dict: dict,
                         tiou_thresholds: Sequence[float] = TIOU_THRESHOLDS
                         ) -> Dict[str, float]:
    """Compute {mIoU, R1@t...} from a loaded prediction dict.

    Returns a dict with keys 'mIoU' (rounded to 2 decimals of percentage,
    like the reference) and 'R1@{t}' percentages (unrounded fractions are in
    'recall_fractions').
    """
    if not all(field in pred_dict for field in PRED_FIELDS):
        raise IOError("Please input a valid proposal file.")
    gts, preds = _collect(pred_dict)
    ious = batched_segment_iou(gts, preds)
    total = len(ious)
    metrics: Dict[str, float] = {}
    recall_fractions = []
    for t in tiou_thresholds:
        frac = float(np.count_nonzero(ious > t)) / total
        recall_fractions.append(frac)
        metrics[f"R1@{t}"] = round(frac * 100, 2)
    metrics["mIoU"] = round(float(ious.mean()) * 100, 2)
    metrics["recall_fractions"] = recall_fractions  # type: ignore[assignment]
    metrics["num_sentences"] = total  # type: ignore[assignment]
    return metrics


def retrieval_eval(filename: str, quiet: bool = False) -> Dict[str, float]:
    """Evaluate a prediction JSON file and print the reference-format table.

    Output format matches grounding/IoU_eval.py:147-153 byte-for-byte so
    downstream log scrapers keep working.
    """
    with open(filename, "r") as fobj:
        pred_dict = json.load(fobj)
    if not quiet:
        print("=> Proposal loaded over.", filename)
    metrics = evaluate_predictions(pred_dict)
    tiou_lst = list(TIOU_THRESHOLDS)
    miou = metrics["mIoU"]
    if not quiet:
        print('\tmIoU\t', '\t'.join([str(i) for i in tiou_lst]))
        print('\n => ')
        recalls = [round(f * 100, 2) for f in metrics["recall_fractions"]]  # type: ignore[index]
        print(1, '\t', miou, '\t', '\t'.join(str(r) for r in recalls))
        # beyond-parity R@k rows (same row shape, rank in column 1; the
        # mIoU column is the best-of-first-k "oracle" mIoU) — printed only
        # when the submit file carries --eval_topk proposals, so default
        # output stays byte-identical to the reference's
        topk_rows = evaluate_topk(pred_dict)
        for r in sorted(topk_rows):
            if r == 1:
                continue
            row = topk_rows[r]
            recs = [round(f * 100, 2) for f in row["recall_fractions"]]  # type: ignore[index]
            print(r, '\t', row["mIoU"], '\t', '\t'.join(str(x) for x in recs))
        print('mIoU\t{:.4f}'.format(miou))
    return metrics
