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
weight/bias; the SCDM ``w`` [Dh, 1] -> ``w.weight`` [1, Dh]; flax's
``nn.Conv`` kernel [K, in, out] -> ``nn.Conv1d``'s weight [out, in, K].
The modules no config key reaches map one by one: ``bigru_to_torch``
(``ops/rnn.BiGRU``), ``dense_tree_to_torch`` (``models/transformer.py``,
``models/graph.py``) and ``_predictor_to_torch`` (the span and content
predictors); :func:`moe_params_from_jax` carries the MoE layer's
parameters (``parallel/expert_parallel.py``), which keep JAX's layout.

Every variant a config selects maps. Where JAX's
``utils/torch_interop.py`` (``:78-100``, ``:205-257``) defines reference
keys, the port's are those: ``span_predictor.predictor.cross_lstm.lstm.*``,
``start_lstm.lstm.*``, ``end_lstm.lstm.*``, ``start_fc``, ``end_fc``,
``csmm.temporal.lstm.lstm.*``. JAX defines none for the conv and the
self-attention predictors (its converter raises for them) or for the RNN
video encoder (it assumes QAVE blocks), and the reference's own modules
for these never ran, so no reference ``.ckp`` exists to check these keys
against. They follow the JAX tree in the pattern of the port's other
modules: ``video_encoder.rnn_cell.lstm.*`` and ``video_encoder.norm``;
``span_predictor.predictor.{start,end}_conv`` (``nn.Conv1d``) and
``{start,end}_fc``; ``span_predictor.predictor.{start,end}_selfattn.
{wq,wk,wv,wo}`` (bias-free) and ``{start,end}_fc``. Their round trip
through the port's own ``.ckp`` (``--start_from``) is strict as every
other module's.
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


def _layers(tree: Dict) -> int:
    """The depth of a BiLSTM's or BiGRU's JAX tree (``w_ih_l{k}`` a
    layer)."""
    return sum(k.startswith('w_ih_l') for k in tree)


def bigru_to_torch(tree: Dict, prefix: str, out: Dict) -> None:
    """JAX ``BiGRU``'s tree (``w_ih_l{k}`` [2, D, 3H], ``w_hh_l{k}``
    [2, H, 3H], ``b_ih_l{k}``, ``b_hh_l{k}`` [2, 3H]) -> ``ops/rnn.BiGRU``'s
    ``nn.GRU`` names: the BiLSTM's layout with 3H gates."""
    bilstm_to_torch(tree, prefix, _layers(tree), out)


def dense_tree_to_torch(tree: Dict, prefix: str, out: Dict) -> None:
    """A tree of dense layers and LayerNorms under nested submodule names
    (``models/transformer.py``, ``models/graph.py``): a ``kernel`` leaf is
    an ``nn.Linear``, a ``scale`` leaf an ``nn.LayerNorm``, at the same
    dotted path."""
    if 'kernel' in tree:
        linear_to_torch(tree, prefix, out)
    elif 'scale' in tree:
        layernorm_to_torch(tree, prefix, out)
    else:
        for name, sub in tree.items():
            dense_tree_to_torch(sub, f'{prefix}.{name}' if prefix else name,
                                out)


def _predictor_to_torch(tree: Dict, prefix: str, out: Dict) -> None:
    """Any span predictor's tree, the content predictors' too
    (``models/content_predictors.py``), by its submodules: BiLSTMs
    (``cross_lstm``, ``start_lstm``, ``end_lstm``, ``content_lstm``) under
    ``<name>.lstm``, the self-attentions' four projections, convolutions
    and dense layers."""
    for name, sub in tree.items():
        p = f'{prefix}.{name}'
        if 'w_ih_l0' in sub:
            bilstm_to_torch(sub, f'{p}.lstm', _layers(sub), out)
        elif 'wq' in sub:
            for w in ('wq', 'wk', 'wv', 'wo'):
                linear_to_torch(sub[w], f'{p}.{w}', out)
        elif np.ndim(sub['kernel']) == 3:
            out[f'{p}.weight'] = _f32(np.transpose(sub['kernel'], (2, 1, 0)))
            out[f'{p}.bias'] = _f32(sub['bias'])
        else:
            linear_to_torch(sub, p, out)


def state_dict_from_jax(params_np: Dict, sent_layers: int = 2,
                        video_layers: int = 2, nblocks: int = 2,
                        baseline: bool = False) -> Dict[str, torch.Tensor]:
    """The JAX package's GMD or (``baseline``) QAVE baseline parameter
    tree -> the port's ``state_dict``. The baseline has no CSMM and no
    discriminator. The variants (video encoder, span predictor, CSMM
    temporal model) are read from the tree; the depth of the predictors'
    and the CSMM's BiLSTMs too."""
    out: Dict[str, torch.Tensor] = {}
    sent = params_np['sentence_encoder']
    linear_to_torch(sent['word_embed'], 'sentence_encoder.word_embed', out)
    bilstm_to_torch(sent['rnn'], 'sentence_encoder.rnn_cell.lstm',
                    sent_layers, out)
    video = params_np['video_encoder']
    if 'block0' not in video:  # the RNN video encoder
        bilstm_to_torch(video['rnn'], 'video_encoder.rnn_cell.lstm',
                        video_layers, out)
        nblocks = 0
    for i in range(nblocks):
        block, p = video[f'block{i}'], f'video_encoder.blocks.{i}'
        bilstm_to_torch(block['rnn'], f'{p}.rnn_cell.lstm', video_layers, out)
        att = block['attention']
        linear_to_torch(att['W_s'], f'{p}.attention.W_s', out)
        linear_to_torch(att['W_a'], f'{p}.attention.W_a', out)
        out[f'{p}.attention.w.weight'] = _f32(np.asarray(att['w']).T)
        linear_to_torch(block['sent_linear'], f'{p}.sent_linear', out)
    layernorm_to_torch(video['norm'], 'video_encoder.norm', out)
    _predictor_to_torch(params_np['span_predictor']['predictor'],
                        'span_predictor.predictor', out)
    if baseline:
        return out
    csmm = params_np['csmm']
    if 'temporal' in csmm:
        bilstm_to_torch(csmm['temporal'], 'csmm.temporal.lstm.lstm',
                        _layers(csmm['temporal']), out)
    linear_to_torch(csmm['predict_1'], 'csmm.predict.predict.0', out)
    linear_to_torch(csmm['predict_2'], 'csmm.predict.predict.2', out)
    linear_to_torch(params_np['tod']['foreback'], 'tod.foreback_context.0', out)
    linear_to_torch(params_np['tod']['classifier'],
                    'tod.fc_classifier_domain_video.0', out)
    return out


def moe_params_from_jax(params_np: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``expert_parallel.init_moe_params``'s tree (numpy arrays) as
    the port's MoE parameters: the same names and layouts (router [C, E],
    w1 [E, C, Hm], b1 [E, Hm], w2 [E, Hm, C], b2 [E, C]), f32."""
    return {k: _f32(params_np[k]) for k in ('router', 'w1', 'b1', 'w2',
                                            'b2')}


def load_reference_ckp(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.ckp``: a raw torch ``state_dict`` (or a dict
    holding one under 'state_dict'), on the CPU."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(obj, dict) and 'state_dict' in obj:
        obj = obj['state_dict']
    return {k: v.float() for k, v in obj.items()}
