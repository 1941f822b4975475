"""The benchmark's tests: the harness on the CPU at tiny widths, and the
card-marked ones (``requires_cuda``) that skip without a card.

    python -m pytest -q port_bench/tests    # on the CPU; on a machine with an
                                            # NVIDIA GPU, the card tests too
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY = {'yml': 'anet_cd_i3d.yml',
        'params': dict(video_feature_dim=16, video_len=12, sent_len=5,
                       sent_rnn_hiddendim=8, video_rnn_hiddendim=8,
                       mlp_hidden_dim=8, m_pred_hidden=16,
                       batch_size=[8, 8, 8], eval_scan_group=2,
                       train_scan_chunk=4),
        'corpus': dict(kind='stats', corpus_seed=0, videos=70, pairs=200,
                       pair_videos=60, duration_s=10.0, duration_shape=4.0,
                       min_duration_s=3.0, clips_per_s=1.0, moment_s=3.0,
                       moment_shape=4.0, words_mean=4.0, vocab=50)}
SEED = 2 ** 31 + 77


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda', 0)
