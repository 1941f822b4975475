"""Inputs and weights made on the device from ``--seed``.

Every tensor comes from a ``torch.Generator`` on the run's device seeded
from (seed, purpose, block), in a few large calls: the weights from one
flat draw, the word vectors from one, a corpus's features block by block
of ``BLOCK`` videos, so that any video's features can be made again from
the seed alone (the reference's block-0 recurrences of a served corpus).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

BLOCK = 64  # videos a feature block
FEATURE_SCALE = 0.8  # features U[0, 0.8): post-ReLU i3d-like, mean 0.4
WORD_STD = 0.4  # word vectors N(0, 0.4^2), GloVe-like scale

_SALT = {'weights': 1, 'words': 2, 'features': 3, 'train': 4}


def generator(seed: int, purpose: str, block: int, device) -> torch.Generator:
    mixed = (int(seed) * 1_000_003 + _SALT[purpose] * 7_919 + block
             * 104_729) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def feature_block(seed: int, block: int, nfeats: np.ndarray, T: int, D: int,
                  device) -> torch.Tensor:
    """Videos ``block * BLOCK ...`` of a corpus: f16 [len(nfeats), T, D],
    zero past each video's clip count."""
    g = generator(seed, 'features', block, device)
    x = torch.rand((len(nfeats), T, D), generator=g, device=device)
    n = torch.as_tensor(np.asarray(nfeats), device=device)
    keep = torch.arange(T, device=device)[None, :] < n[:, None]
    return (x * FEATURE_SCALE * keep[..., None]).to(torch.float16)


def features(seed: int, nfeats: np.ndarray, T: int, D: int,
             device) -> torch.Tensor:
    """The whole corpus, [V, T, D] f16 on ``device``."""
    V = len(nfeats)
    out = torch.empty((V, T, D), dtype=torch.float16, device=device)
    for b in range(0, -(-V // BLOCK)):
        lo, hi = b * BLOCK, min((b + 1) * BLOCK, V)
        out[lo:hi] = feature_block(seed, b, nfeats[lo:hi], T, D, device)
    return out


def rows_features(seed: int, nfeats: np.ndarray, rows: Iterable[int], T: int,
                  D: int, device) -> torch.Tensor:
    """Videos ``rows`` of the corpus, made again from the seed: f16."""
    rows = np.asarray(list(rows))
    out = torch.empty((len(rows), T, D), dtype=torch.float16, device=device)
    for b in np.unique(rows // BLOCK):
        lo = b * BLOCK
        blk = feature_block(seed, int(b), nfeats[lo:lo + BLOCK], T, D, device)
        sel = np.nonzero(rows // BLOCK == b)[0]
        out[torch.as_tensor(sel, device=device)] = blk[
            torch.as_tensor(rows[sel] - lo, device=device)]
    return out


def words(seed: int, vocab: int, dim: int, device) -> torch.Tensor:
    return torch.randn((vocab, dim), generator=generator(
        seed, 'words', 0, device), device=device) * WORD_STD


def _bound(name: str, shape: Tuple[int, ...],
           shapes: Dict[str, Tuple[int, ...]]) -> Tuple[float, float]:
    """(scale, offset) of U[0,1) for a parameter, torch's default
    initialisation: LSTM tensors U(+-1/sqrt(H)); a linear layer's weight
    and bias U(+-1/sqrt(fan_in)); LayerNorm 1 and 0."""
    if '.norm.' in name:
        return (0.0, 1.0) if name.endswith('weight') else (0.0, 0.0)
    if '.lstm.' in name:
        b = 1.0 / math.sqrt(shape[0] // 4)
    elif name.endswith('.bias'):
        b = 1.0 / math.sqrt(shapes[name[:-len('bias')] + 'weight'][1])
    else:
        b = 1.0 / math.sqrt(shape[1])
    return 2 * b, -b


def weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
            device) -> Dict[str, torch.Tensor]:
    """Every parameter from one flat draw: {name: f32 tensor}."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=generator(seed, 'weights', 0, device),
                      device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale, offset = _bound(name, shape, shapes)
        out[name] = (flat[at:at + n] * scale + offset).view(shape)
        at += n
    return out
