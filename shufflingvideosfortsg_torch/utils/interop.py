"""Weights in and out of the port.

The port's modules carry the reference torch ``state_dict`` names, so a
reference ``.ckp`` (a raw ``model.state_dict()``) loads as it is:
:func:`load_reference_ckp`. :func:`state_dict_from_jax` maps the JAX
package's parameter tree (numpy arrays) onto the same keys; it is the
port's own copy of the export direction of
``shufflingvideosfortsg_tpu/utils/torch_interop.py`` (``:158-257``).
JAX msgpack checkpoints reach the port through
``tools/export_reference_ckp.py``, which writes a reference ``.ckp``.

Layouts: ``nn.Linear`` kernel [in, out] -> weight [out, in]; the BiLSTM's
[2, D, 4H]-stacked directions -> per-direction ``weight_ih_l{k}[_reverse]``
[4H, D] (and ``weight_hh``, both biases); LayerNorm scale/bias ->
weight/bias; the SCDM ``w`` [Dh, 1] -> ``w.weight`` [1, Dh].
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order='C'))


def linear_to_torch(tree: Dict, prefix: str, out: Dict) -> None:
    out[f'{prefix}.weight'] = _f32(np.asarray(tree['kernel']).T)
    if 'bias' in tree:
        out[f'{prefix}.bias'] = _f32(tree['bias'])


def layernorm_to_torch(tree: Dict, prefix: str, out: Dict) -> None:
    out[f'{prefix}.weight'] = _f32(tree['scale'])
    out[f'{prefix}.bias'] = _f32(tree['bias'])


def bilstm_to_torch(tree: Dict, prefix: str, num_layers: int,
                    out: Dict) -> None:
    for layer in range(num_layers):
        for r, rev in enumerate(('', '_reverse')):
            for name in ('ih', 'hh'):
                out[f'{prefix}.weight_{name}_l{layer}{rev}'] = _f32(
                    np.asarray(tree[f'w_{name}_l{layer}'])[r].T)
                out[f'{prefix}.bias_{name}_l{layer}{rev}'] = _f32(
                    np.asarray(tree[f'b_{name}_l{layer}'])[r])


def state_dict_from_jax(params_np: Dict, sent_layers: int = 2,
                        video_layers: int = 2, nblocks: int = 2,
                        predictor_name: str = 'mlp',
                        m_temp: str = 'none',
                        baseline: bool = False) -> Dict[str, torch.Tensor]:
    """The JAX package's GMD or (``baseline``) QAVE baseline parameter
    tree -> the port's ``state_dict``. The baseline has no CSMM and no
    discriminator.

    Covers what the port builds: the 'mlp' span predictor and CSMM
    without a temporal model; other settings raise."""
    if predictor_name not in ('mlp', 'a'):
        raise NotImplementedError(f'span predictor {predictor_name!r} is not '
                                  'ported yet (only "mlp")')
    if m_temp.lower() != 'none':
        raise NotImplementedError(f'CSMM temporal {m_temp!r} is not ported '
                                  'yet (only "none")')
    out: Dict[str, torch.Tensor] = {}
    sent = params_np['sentence_encoder']
    linear_to_torch(sent['word_embed'], 'sentence_encoder.word_embed', out)
    bilstm_to_torch(sent['rnn'], 'sentence_encoder.rnn_cell.lstm',
                    sent_layers, out)
    video = params_np['video_encoder']
    for i in range(nblocks):
        block, p = video[f'block{i}'], f'video_encoder.blocks.{i}'
        bilstm_to_torch(block['rnn'], f'{p}.rnn_cell.lstm', video_layers, out)
        att = block['attention']
        linear_to_torch(att['W_s'], f'{p}.attention.W_s', out)
        linear_to_torch(att['W_a'], f'{p}.attention.W_a', out)
        out[f'{p}.attention.w.weight'] = _f32(np.asarray(att['w']).T)
        linear_to_torch(block['sent_linear'], f'{p}.sent_linear', out)
    layernorm_to_torch(video['norm'], 'video_encoder.norm', out)
    pred = params_np['span_predictor']['predictor']
    for n in ('start_mlp_1', 'start_mlp_2', 'end_mlp_1', 'end_mlp_2'):
        linear_to_torch(pred[n], f'span_predictor.predictor.{n}', out)
    if baseline:
        return out
    csmm = params_np['csmm']
    linear_to_torch(csmm['predict_1'], 'csmm.predict.predict.0', out)
    linear_to_torch(csmm['predict_2'], 'csmm.predict.predict.2', out)
    linear_to_torch(params_np['tod']['foreback'], 'tod.foreback_context.0', out)
    linear_to_torch(params_np['tod']['classifier'],
                    'tod.fc_classifier_domain_video.0', out)
    return out


def load_reference_ckp(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.ckp``: a raw torch ``state_dict`` (or a dict
    holding one under 'state_dict'), on the CPU."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(obj, dict) and 'state_dict' in obj:
        obj = obj['state_dict']
    return {k: v.float() for k, v in obj.items()}
