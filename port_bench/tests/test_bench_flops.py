"""The yardstick's operation and byte counts against hand-worked values."""

import pytest

from harness import flops

TINY = dict(video_len=2, sent_len=1, video_feature_dim=3,
            sent_embedding_dim=2, sent_rnn_hiddendim=1,
            video_rnn_hiddendim=1, sent_rnn_layers=1, video_rnn_layers=1,
            mlp_hidden_dim=1, m_pred_hidden=1)


def test_recurrence_and_lstm_bounds():
    assert flops.recurrence_flops(3, 2, 4) == 2 * 2 * 2 * 2 * 4 * 16
    assert flops.recurrence_flops(1, 5, 8) == 0
    T, B, H = 128, 64, 256
    f = 2 * 127 * 2 * 64 * 256 * 1024
    io = 4 * (T * B * 8 * H + 2 * H * 4 * H + T * B * 2 * H)
    b = flops.lstm_bounds(T, B, H)
    assert b['K1'] == pytest.approx(max(f / 67e12, (io + 16 * B * H) / 3.35e12))
    assert b['K4'] >= 3 * f / 67e12


def test_scdm_bounds():
    # terms 24, context 30: 4*24 + 2*30 = 156 operations; 49 f32 inputs
    # and outputs plus P (6) kept: 220 bytes, so bytes bound it
    assert flops.scdm_bound(1, 2, 3, 4, 5, keep_p=True) == \
        pytest.approx(220 / 3.35e12)
    # K5's backward at a train step's shape: 62,914,560 terms of 10
    # operations (9.39 us) against 9,372,672 inputs and gradients, 122,880
    # dP and 122,880 P of 4 bytes (38,473,728 bytes, 11.48 us)
    assert flops.scdm_bwd_bound(64, 128, 15, 512) == pytest.approx(
        38_473_728 / 3.35e12)


@pytest.mark.parametrize('kind,expected', [('eval', 404), ('serve', 292),
                                           ('train', 2320)])
def test_model_flops_by_hand(kind, expected):
    """Worked out term by term in the test file's docstring of the
    derivation (harness/flops.model_flops) at T=2, N=1, D=3, W=2, all
    widths 1, one layer each, one row."""
    assert flops.model_flops(TINY, kind, 1) == expected


def test_launches_of_a_step():
    p = dict(TINY, video_len=128, sent_len=15, sent_rnn_layers=2,
             video_rnn_layers=2, sent_rnn_hiddendim=256,
             video_rnn_hiddendim=256)
    train = flops.launches(p, 'train', 32)
    assert train['lstm'] == [(15, 32, 256)] * 2 + [(128, 64, 256)] * 4
    assert train['scdm'] == [(64, 128, 15, 512, 512)] * 2
    serve = flops.launches(p, 'serve', 512)
    assert serve['lstm'] == [(15, 512, 256)] * 2 + [(128, 512, 256)] * 2
