"""The yardstick's arithmetic: the card's peaks, the least times of the
port's kernels, and GMD's model operations a step.

Frozen copies, so that a later change to the program cannot move them:

- the peaks of an NVIDIA H100 SXM from its data sheet (dense, 700 W);
- :func:`recurrence_flops` and :func:`lstm_bounds` (the port's
  ``chip_smoke.py``): a BiLSTM layer's recurrence products and the least
  time of K1, K3 and K4 (recurrence and weight gradient) at (T, B, H);
- :func:`scdm_bound` and :func:`scdm_bwd_bound` (the port's
  ``measure_scdm.py``), f32: the least time of K2 and of K5's backward.

:func:`model_flops` counts a step's model operations from the
configuration's shapes; its docstring gives the derivation.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_F32_FLOPS = 67e12    # f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # bf16 dense tensor cores
PEAK_BYTES = 3.35e12      # HBM3


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS
          ) -> float:
    """Least seconds: the larger of operations over the peak and bytes
    over the memory rate."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def recurrence_flops(T: int, B: int, H: int) -> int:
    """The operations of a BiLSTM recurrence's products at (T, B, H): one
    h @ W_hh a step and direction, but not at step 0, where h is zero."""
    return 2 * max(T - 1, 0) * 2 * B * H * 4 * H


def lstm_bounds(T: int, B: int, H: int, es: int = 4) -> Dict[str, float]:
    """Least seconds of K1, K3 and K4 (its three products: the gate
    recompute, dh_prev and the weight gradient) at (T, B, H), storage of
    ``es`` bytes for xw, out and d_out, f32 for the rest."""
    flops = recurrence_flops(T, B, H)
    io = es * (T * B * 8 * H + 2 * H * 4 * H + T * B * 2 * H)
    state = 4 * (T * 2 * B * H + 4 * B * H)
    return {'K1': bound(flops, io + 4 * 4 * B * H),
            'K3': bound(flops, io + state),
            'K4': bound(3 * flops, io + es * T * B * 2 * H
                        + 4 * (T * B * 8 * H + 2 * H * 4 * H) + state)}


def scdm_bound(B: int, T: int, N: int, Dh: int, Ds: int,
               keep_p: bool) -> float:
    """Least seconds of K2 in f32: per (b,t,n,k) an add, a tanh and the
    logit's multiply-add (4 operations), per (b,t,n,d) the context's
    multiply-add; each input read once, C (and P where kept) written."""
    terms, ctx = B * T * N * Dh, B * T * N * Ds
    nbytes = (4 * (B * T * Dh + B * N * Dh + Dh + B * N * Ds + B * T * Ds)
              + (4 * B * T * N if keep_p else 0))
    return bound(4 * terms + 2 * ctx, nbytes)


def scdm_bwd_bound(B: int, T: int, N: int, Dh: int) -> float:
    """Least seconds of K5's backward kernel in f32: 10 operations a
    (b,t,n,k) term; its inputs and P read once, its gradients written."""
    terms = B * T * N * Dh
    nbytes = 4 * (2 * (B * T * Dh + B * N * Dh + Dh) + B * T * N) \
        + 4 * B * T * N
    return bound(10 * terms, nbytes)


def widths(params: Dict) -> Dict[str, int]:
    p = params
    return dict(T=int(p['video_len']), N=int(p['sent_len']),
                D=int(p['video_feature_dim']), W=int(p['sent_embedding_dim']),
                Hs=int(p['sent_rnn_hiddendim']),
                Hv=int(p['video_rnn_hiddendim']),
                Ls=int(p['sent_rnn_layers']), Lv=int(p['video_rnn_layers']),
                M=int(p['mlp_hidden_dim']), C=int(p['m_pred_hidden']),
                blocks=2)


def _lstm_layers(T: int, B: int, d_in: int, H: int, layers: int):
    """[(input width, T, B, H)] of a stacked BiLSTM."""
    return [(d_in if k == 0 else 2 * H, T, B, H) for k in range(layers)]


def launches(params: Dict, kind: str, rows: int) -> Dict[str, List[Tuple]]:
    """The shapes of the recurrence and SCDM launches of one unit of work
    (a train step of ``rows`` pairs, an eval tick or a served batch of
    ``rows`` sentences): {'lstm': [(T, B, H)], 'scdm': [(B, T, N, Dh,
    Ds)]}. Training runs the video encoder on raw and pseudo videos (2
    rows a pair); serving skips block 0's recurrence (cached)."""
    w = widths(params)
    R = 2 * rows if kind == 'train' else rows
    lstm = [(w['N'], rows, w['Hs'])] * w['Ls']
    first = 1 if kind == 'serve' else 0
    lstm += [(w['T'], R, w['Hv'])] * (w['Lv'] * (w['blocks'] - first))
    scdm = [(R, w['T'], w['N'], 2 * w['Hv'], 2 * w['Hs'])] * w['blocks']
    return {'lstm': lstm, 'scdm': scdm}


def least_seconds(params: Dict, kind: str, rows: int) -> Dict[str, float]:
    """Least seconds of one unit's recurrence launches (K1, or K3 + K4 in
    training) and SCDM launches (K2, or K2 keeping P + K5's backward)."""
    shapes = launches(params, kind, rows)
    if kind == 'train':
        lstm = sum(lstm_bounds(*s)['K3'] + lstm_bounds(*s)['K4']
                   for s in shapes['lstm'])
        scdm = sum(scdm_bound(*s, keep_p=True) + scdm_bwd_bound(*s[:4])
                   for s in shapes['scdm'])
    else:
        lstm = sum(lstm_bounds(*s)['K1'] for s in shapes['lstm'])
        scdm = sum(scdm_bound(*s, keep_p=False) for s in shapes['scdm'])
    return {'lstm': lstm, 'scdm': scdm}


def model_flops(params: Dict, kind: str, rows: int) -> float:
    """GMD's model operations for one unit of work, from the shapes.

    Counted: every product of two operands, 2 operations a multiply-add,
    at the sizes the unit runs, and nothing recomputed. A dense layer
    [m, k] @ [k, n] is 2mkn. A BiLSTM layer over (T, B) with input d and
    hidden H is its input products 2·T·B·d·8H and its recurrence
    :func:`recurrence_flops` (no product at step 0, where h is zero).
    SCDM at (R, T, N) is W_a 2·R·T·2Hv·2Hv, W_s 2·R·N·2Hs·2Hv, the logits
    2·R·T·N·2Hv and the context 2·R·T·N·2Hs; its gate ``sent_linear``
    2·R·T·2Hs·2Hv. CSMM's MLP 2·R·T·(2Hv+2Hs)·C + 2·R·T·C, the span heads
    2 · (2·B·T·(2Hv+2Hs)·M + 2·B·T·M), the word projection 2·B·N·W·W.
    Element-wise operations (gates, tanh, softmax, norms, losses) are not
    counted.

    ``train``: the video encoder and CSMM run on R = 2·rows (raw and
    pseudo), the span heads on the raw rows, plus the order
    discriminator (its shared layer twice, 2 · 2·R·4Hv·2Hv, and
    2·R·6Hv·2). The backward counts twice
    each forward product (the gradient of its input and of its weight),
    less the input gradients nobody needs: of the word projection (the
    word vectors are fixed) and of block 0's first input products (the
    features are fixed), 2·B·N·W·W and 2·T·R·D·8Hv. ``eval``: the
    forward at R = rows. ``serve``: the forward at R = rows without block
    0's recurrence (cached at set-up)."""
    w = widths(params)
    T, N, Hs, Hv = w['T'], w['N'], w['Hs'], w['Hv']
    B = rows
    R = 2 * B if kind == 'train' else B

    def lstm_layer(d, t, b, h):
        return 2 * t * b * d * 8 * h + recurrence_flops(t, b, h)

    f = 2 * B * N * w['W'] * w['W']
    f += sum(lstm_layer(*s) for s in _lstm_layers(N, B, w['W'], Hs, w['Ls']))
    for blk in range(w['blocks']):
        if not (kind == 'serve' and blk == 0):
            d_in = w['D'] if blk == 0 else 2 * Hv
            f += sum(lstm_layer(*s)
                     for s in _lstm_layers(T, R, d_in, Hv, w['Lv']))
        f += 2 * R * T * (2 * Hv) * (2 * Hv)           # W_a
        f += 2 * R * N * (2 * Hs) * (2 * Hv)           # W_s
        f += 2 * R * T * N * (2 * Hv + 2 * Hs)         # logits, context
        f += 2 * R * T * (2 * Hs) * (2 * Hv)           # sent_linear
    cross = 2 * Hv + 2 * Hs
    f += 2 * R * T * cross * w['C'] + 2 * R * T * w['C']
    f += 2 * (2 * B * T * cross * w['M'] + 2 * B * T * w['M'])
    if kind != 'train':
        return float(f)
    f += 2 * 2 * R * (4 * Hv) * (2 * Hv) + 2 * R * (6 * Hv) * 2
    unneeded = 2 * B * N * w['W'] * w['W'] + 2 * T * R * w['D'] * 8 * Hv
    return float(3 * f - unneeded)
