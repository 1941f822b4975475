"""The plain reference: GMD, its four-term loss and Adam in plain PyTorch.

An independent implementation of the shuffling framework's grounding
model (arXiv 2207.14698, the reference code's ``SpanGroundMatchDisc``)
as loops of ``torch`` operations in float32, written for the benchmark's
correctness check. It imports nothing of the measured package. It reads
the weights the benchmark made (a dict keyed by the reference's
``state_dict`` names) and the inputs the benchmark made, and works
everything else out again: the masks, the pseudo videos, the dropout
masks (drawn from a generator seeded as the program's, in the program's
order), the block-0 recurrences of a served corpus.

Departures from the published description, each also the program's:
dropout masks are drawn per layer output from one generator; the video
mask covers clips 0..nfeats inclusive and the fore and back masks include
the moment's boundary clips (the reference code's ``sequence_mask``);
the span decode maximises start_prob[s] + end_prob[e] over e >= s.

``tf32=True`` runs every product of the reference in TF32 (the control of
the f32 cells: the nearest precision below the configuration's).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor
F32 = torch.float32


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 products on (the control) or off (the reference) inside."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def draw(shape, gen: Optional[torch.Generator], device) -> Tensor:
    """f32 U[0, 1) draws, as the program draws each of its random numbers."""
    return torch.rand(tuple(int(s) for s in shape), generator=gen,
                      device=device, dtype=F32)


def dropout(x: Tensor, p: float, gen, training: bool) -> Tensor:
    if not training or p <= 0:
        return x
    keep = 1.0 - p
    u = draw(x.shape, gen, x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def linear(w: Dict[str, Tensor], name: str, x: Tensor) -> Tensor:
    y = x @ w[name + '.weight'].t()
    b = w.get(name + '.bias')
    return y if b is None else y + b


def lstm_direction(xw: Tensor, w_hh: Tensor, reverse: bool
                   ) -> Tuple[Tensor, Tensor]:
    """One direction over xw [B, T, 4H] (input products and both biases),
    gates i, f, g, o, zero initial state: (outputs [B, T, H], final h)."""
    B, T, _ = xw.shape
    H = w_hh.shape[1]
    h = xw.new_zeros(B, H)
    c = xw.new_zeros(B, H)
    outs: List[Optional[Tensor]] = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xw[:, t] + h @ w_hh.t()
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs[t] = h
    return torch.stack(outs, dim=1), h


def bilstm(w: Dict[str, Tensor], prefix: str, x: Tensor, layers: int,
           p_drop: float, gen, training: bool) -> Tuple[Tensor, Tensor]:
    """A bidirectional ``layers``-deep LSTM over x [B, T, D] with dropout
    on every layer's output but the last: (outputs [B, T, 2H], the last
    layer's final forward and backward h, concatenated)."""
    inputs, last = x, None
    for k in range(layers):
        outs, finals = [], []
        for sfx, reverse in (('', False), ('_reverse', True)):
            xw = (inputs @ w[f'{prefix}.weight_ih_l{k}{sfx}'].t()
                  + w[f'{prefix}.bias_ih_l{k}{sfx}']
                  + w[f'{prefix}.bias_hh_l{k}{sfx}'])
            out, h = lstm_direction(xw, w[f'{prefix}.weight_hh_l{k}{sfx}'],
                                    reverse)
            outs.append(out)
            finals.append(h)
        inputs = torch.cat(outs, dim=-1)
        last = torch.cat(finals, dim=-1)
        if k + 1 < layers:
            inputs = dropout(inputs, p_drop, gen, training)
    return inputs, last


def layer_norm(w: Dict[str, Tensor], name: str, x: Tensor) -> Tensor:
    return torch.nn.functional.layer_norm(
        x, x.shape[-1:], w[name + '.weight'], w[name + '.bias'], 1e-5)


def scdm(w: Dict[str, Tensor], prefix: str, frames: Tensor,
         words: Tensor) -> Tensor:
    """Additive word attention: per frame t a softmax over the words of
    w . tanh(W_a v_t + W_s s_n), and the words weighted by it."""
    vp = linear(w, prefix + '.W_a', frames)
    sp = linear(w, prefix + '.W_s', words)
    act = torch.tanh(vp[:, :, None, :] + sp[:, None, :, :])
    logits = act @ w[prefix + '.w.weight'][0]
    return torch.softmax(logits, dim=-1) @ words


class Model:
    """GMD's equations over a weight dict; ``cfg`` holds the widths
    (``video_layers``, ``sent_layers``, ``nblocks``, ``dropout``,
    ``disc_dropout``)."""

    def __init__(self, weights: Dict[str, Tensor], cfg: Dict):
        self.w = weights
        self.cfg = cfg

    def encode_query(self, query: Tensor, gen, training: bool):
        x = linear(self.w, 'sentence_encoder.word_embed', query)
        return bilstm(self.w, 'sentence_encoder.rnn_cell.lstm', x,
                      self.cfg['sent_layers'], self.cfg['dropout'], gen,
                      training)

    def block_rnn(self, b: int, x: Tensor, gen, training: bool) -> Tensor:
        return bilstm(self.w, f'video_encoder.blocks.{b}.rnn_cell.lstm', x,
                      self.cfg['video_layers'], self.cfg['dropout'], gen,
                      training)[0]

    def block_gate(self, b: int, rnn: Tensor, words: Tensor) -> Tensor:
        prefix = f'video_encoder.blocks.{b}'
        ctx = scdm(self.w, prefix + '.attention', rnn, words)
        return rnn * torch.sigmoid(linear(self.w, prefix + '.sent_linear',
                                          ctx))

    def video(self, video: Tensor, words: Tensor, gen, training: bool,
              rnn0: Optional[Tensor] = None) -> Tensor:
        """QAVE; ``rnn0``, where given, is block 0's recurrence."""
        x = video
        for b in range(self.cfg['nblocks']):
            rnn = rnn0 if (b == 0 and rnn0 is not None) else \
                self.block_rnn(b, x, gen, training)
            x = self.block_gate(b, rnn, words)
        return layer_norm(self.w, 'video_encoder.norm', x)

    def match(self, frames: Tensor, sent: Tensor) -> Tensor:
        T = frames.shape[1]
        feat = torch.cat([frames, sent[:, None].expand(-1, T, -1)], -1)
        hidden = torch.relu(linear(self.w, 'csmm.predict.predict.0', feat))
        return linear(self.w, 'csmm.predict.predict.2', hidden)[..., 0]

    def span(self, frames: Tensor, sent: Tensor, match: Tensor):
        T = frames.shape[1]
        feat = match[:, :, None] * torch.cat(
            [frames, sent[:, None].expand(-1, T, -1)], -1)
        p = 'span_predictor.predictor.'
        probs = []
        for side in ('start', 'end'):
            h = torch.tanh(linear(self.w, p + side + '_mlp_1', feat))
            probs.append(torch.softmax(
                linear(self.w, p + side + '_mlp_2', h)[..., 0], dim=1))
        return probs[0], probs[1]

    def tod(self, frames: Tensor, target: Tensor, fore: Tensor,
            back: Tensor, gen, training: bool) -> Tensor:
        def pool(m):
            m = m.to(F32)
            return (frames * m[..., None]).sum(1) / (m.sum(1, keepdim=True)
                                                     + 1e-6)
        t, f, b = pool(target), pool(fore), pool(back)
        name = 'tod.foreback_context.0'
        f = torch.relu(linear(self.w, name, torch.cat([f, t], -1)))
        b = torch.relu(linear(self.w, name, torch.cat([t, b], -1)))
        x = dropout(torch.cat([t, f, b], -1), self.cfg['disc_dropout'], gen,
                    training)
        return linear(self.w, 'tod.fc_classifier_domain_video.0', x)

    def ground(self, video: Tensor, query: Tensor,
               rnn0: Optional[Tensor] = None):
        """Inference (no dropout): (start_prob, end_prob) [B, T]."""
        words, sent = self.encode_query(query, None, False)
        frames = self.video(video, words, None, False, rnn0)
        return self.span(frames, sent, self.match(frames, sent))

    def block0(self, video: Tensor) -> Tensor:
        """Block 0's query-independent recurrence of videos [V, T, D]."""
        return self.block_rnn(0, video, None, False)


# -- the batch, its masks and the pseudo videos --------------------------------

def inclusive(lo: Tensor, hi: Tensor, T: int) -> Tensor:
    """[B, T] 1 where lo <= t <= hi (hi clipped to T-1, lo to 0)."""
    t = torch.arange(T, device=lo.device)[None]
    return ((t >= lo.long().clamp(min=0)[:, None])
            & (t <= hi.long().clamp(max=T - 1)[:, None])).to(torch.int32)


def masks(s: Tensor, e: Tensor, n: Tensor, T: int) -> Dict[str, Tensor]:
    zero = torch.zeros_like(n)
    return {'video_mask': inclusive(zero, n, T),
            'temporal': inclusive(s, e, T),
            'fore': inclusive(zero, s, T),
            'back': inclusive(e, n, T)}


def translate(u: Tensor, video: Tensor, se: Tensor, n: Tensor):
    """The moment of each video moved to a uniformly drawn place (the
    reference code's ``gt_moment_translate``: np.delete the moment, then
    np.insert it at ``cropin`` = floor(u (n - L + 1)), uniform on
    [0, n - L]), row by row.
    Returns (pseudo video, pseudo [s, e])."""
    B, T, _ = video.shape
    rows, spans = [], []
    for b in range(B):
        s, e, nb = int(se[b, 0]), int(se[b, 1]), int(n[b])
        L = e - s + 1
        if L <= 1 or L >= nb:
            rows.append(torch.arange(T))
            spans.append((s, e))
            continue
        hi = max(nb - L, 0)
        # u * (hi + 1) rounded to f32, as the draw is: f64 would round
        # some products the other side of an integer
        cropin = min(int((u[b:b + 1].float() * float(hi + 1)).long()), hi)
        rest = [j for j in range(T) if not s <= j <= e]
        order = rest[:cropin] + list(range(s, e + 1)) + rest[cropin:]
        rows.append(torch.tensor(order))
        spans.append((cropin, cropin + L - 1))
    idx = torch.stack(rows).to(video.device)
    pseudo = torch.gather(video, 1, idx[:, :, None].expand_as(video))
    return pseudo, torch.tensor(spans, device=video.device)


def _f32(x: Tensor) -> Tensor:
    return x.to(F32)


# -- the loss -----------------------------------------------------------------

def bce(logits: Tensor, labels: Tensor, mask: Tensor) -> Tensor:
    x, z, m = _f32(logits), _f32(labels), _f32(mask)
    per = x.clamp(min=0) - x * z + torch.log1p(torch.exp(-x.abs()))
    return (per * m).sum() / (m.sum() + 1e-4)


def masked_softmax(x: Tensor, mask: Tensor) -> Tensor:
    e = torch.exp(x) * _f32(mask)
    return e / (e.sum(1, keepdim=True) + 1e-4)


def span_kl(p1: Tensor, p2: Tensor, se1: Tensor, se2: Tensor) -> Tensor:
    B, T = p1.shape
    k = torch.arange(T, device=p1.device)[None]
    s1, e1, s2 = se1[:, :1].long(), se1[:, 1:2].long(), se2[:, :1].long()
    a = torch.gather(p1, 1, (s1 + k).clamp(0, T - 1))
    b = torch.gather(p2, 1, (s2 + k).clamp(0, T - 1))
    kl = a * torch.log((a + 1e-4) / (b + 1e-4))
    return (kl * (k <= e1 - s1).to(F32)).sum(1).mean()


def nll(start: Tensor, end: Tensor, se: Tensor) -> Tensor:
    """Per-row -log p_start[s] - log p_end[e]."""
    se = se.long()
    return -(torch.log(start.gather(1, se[:, :1])[:, 0])
             + torch.log(end.gather(1, se[:, 1:2])[:, 0]))


TERMS = ('loss_g', 'loss_intra', 'loss_inter', 'loss_d')


def train_loss(model: Model, batch: Dict[str, Tensor], gen,
               lambdas=(1.0, 1.0, 1.0),
               parts: Optional[Dict[str, float]] = None) -> Tensor:
    """The training loss of one batch (``video`` [B, T, D], ``query``
    [B, N, 300], ``se`` [B, 2], ``nfeats`` [B]), drawing the pseudo
    videos' places and then the dropout masks from ``gen``. ``parts``,
    where given, receives the four terms (``TERMS``)."""
    m1, m2, md = lambdas
    video, se, n = batch['video'], batch['se'], batch['nfeats']
    B, T, _ = video.shape
    u = draw((B,), gen, video.device)
    pseudo, pse = translate(u, video, se, n)
    mo = masks(se[:, 0], se[:, 1], n, T)
    mp = masks(pse[:, 0], pse[:, 1], n, T)
    words, sent = model.encode_query(batch['query'], gen, True)
    frames = model.video(torch.cat([video, pseudo]),
                         torch.cat([words, words]), gen, True)
    sent2 = torch.cat([sent, sent])
    match = model.match(frames, sent2)
    start, end = model.span(frames[:B], sent, match[:B])
    disc = model.tod(frames, torch.cat([mo['temporal'], mp['temporal']]),
                     torch.cat([mo['fore'], mp['fore']]),
                     torch.cat([mo['back'], mp['back']]), gen, True)
    loss_g = nll(start, end, se).mean()
    intra = (bce(match[:B], mo['temporal'], mo['video_mask'])
             + bce(match[B:], mp['temporal'], mp['video_mask']))
    inter = span_kl(masked_softmax(match[:B], mo['temporal']),
                    masked_softmax(match[B:], mp['temporal']), se, pse)
    logp = torch.log_softmax(disc, dim=-1)
    loss_d = -(logp[:B, 0].sum() + logp[B:, 1].sum()) / (2 * B)
    if parts is not None:
        parts.update(zip(TERMS, (float(t.detach()) for t in
                                 (loss_g, intra, inter, loss_d))))
    return loss_g + m1 * intra + m2 * inter + md * loss_d


class Adam:
    """torch's Adam: weight decay added to the gradient, bias-corrected
    moments, eps outside the square root."""

    def __init__(self, params: Dict[str, Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        self.params, self.lr, self.betas = params, lr, betas
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """One update; returns the gradients as the moments took them."""
        self.t += 1
        b1, b2 = self.betas
        taken = {}
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t)
                     + self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** self.t))
        return taken


def train_steps(weights: Dict[str, Tensor], cfg: Dict,
                batches: Sequence[Dict[str, Tensor]], gen, lr: float,
                weight_decay: float, eps: float = 1e-6):
    """``len(batches)`` Adam updates from ``weights`` (copied): (each
    step's loss, the first update's gradients as Adam took them (weight
    decay added), the first gradients of the loss alone, each parameter's
    change over all the updates, the first step's loss terms)."""
    params = {k: v.detach().clone().to(F32).requires_grad_(True)
              for k, v in weights.items()}
    opt = Adam(params, lr, eps=eps, weight_decay=weight_decay)
    model = Model(params, cfg)
    losses, first, raw, parts = [], None, None, {}
    for batch in batches:
        loss = train_loss(model, batch, gen, parts=None if losses else parts)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(params, grads)}
        losses.append(float(loss.detach()))
        taken = opt.step(grads)
        if first is None:
            first, raw = taken, grads
    change = {k: (params[k].detach() - weights[k].to(F32))
              for k in params}
    return losses, first, raw, change, parts


def decode(start: Tensor, end: Tensor) -> Tuple[Tensor, Tensor]:
    """(best [s, e] with e >= s, its score start[s] + end[e]) by the full
    [T, T] matrix."""
    T = start.shape[1]
    mat = start[:, :, None] + end[:, None, :]
    upper = torch.triu(torch.ones(T, T, dtype=torch.bool,
                                  device=start.device))
    mat = mat.masked_fill(~upper, float('-inf')).flatten(1)
    score, flat = mat.max(dim=1)
    return torch.stack([flat // T, flat % T], -1), score
