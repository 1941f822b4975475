"""Merge the per-rank submit parts of a data-parallel evaluation.

The port's own copy of ``tools/merge_submits.py``. A run on more than one
rank writes one prediction JSON a rank (``<alias>_<step>_<split>.partN.json``,
disjoint stripes of the sentences: ``cli._submit_key``); :func:`merge`
joins them into one submit of the reference schema, on which
``IoU_eval.py`` (or ``eval/iou.retrieval_eval``) reports the global table.

    python -m shufflingvideosfortsg_torch.merge_submits out.json \\
        part0.json part1.json [...]
"""

import json
import sys


def merge(paths):
    """The submit of the first part, each later part's predictions added
    video by video, in the parts' order."""
    out = None
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        if out is None:
            out = d
            continue
        for vid, rows in d['results'].items():
            out['results'].setdefault(vid, []).extend(rows)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        sys.exit(__doc__)
    out_path, parts = argv[0], argv[1:]
    merged = merge(parts)
    n = sum(len(v) for v in merged['results'].values())
    with open(out_path, 'w') as f:
        json.dump(merged, f)
    print(f'merged {len(parts)} shards -> {out_path} ({n} predictions)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
