"""Model construction from the flat parameter namespace.

Counterpart of ``shufflingvideosfortsg_tpu/models/build.py:14-75``. There
is no ``fused_inference`` switch: the device of the tensors picks the
implementation (kernels on a CUDA device, their plain versions on the
CPU). ``precision`` picks the compute dtype, f32 or bf16, as JAX's
``_dtype`` does; the weights stay f32 either way.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch
from torch import nn

from .baseline import Baseline
from .gmd import GMD

GMD_KINDS = ('gmd', 'qave_match')
BASELINE_KINDS = ('baseline', 'qave')


def compute_dtype(params: Dict[str, Any]) -> torch.dtype:
    """bf16 for ``precision`` bf16 (or bfloat16), else f32."""
    bf16 = str(params.get('precision', 'f32')).lower() in ('bf16', 'bfloat16')
    return torch.bfloat16 if bf16 else torch.float32


def model_config_from_params(params: Dict[str, Any]) -> Dict[str, Any]:
    return dict(
        video_feature_dim=params['video_feature_dim'],
        word_dim=params['sent_embedding_dim'],
        sent_hidden=params['sent_rnn_hiddendim'],
        sent_layers=params['sent_rnn_layers'],
        video_encoder_name=params['video_encoder'],
        video_hidden=params['video_rnn_hiddendim'],
        video_layers=params['video_rnn_layers'],
        # the deepened QAVE of the pipeline-parallel trainer keeps its
        # checkpoints sequential, so test drivers build the same depth
        nblocks=(int(params['pipeline_stages']) + 1
                 if params.get('pipeline_stages') else 2),
        cross_name=params['crossmodal'],
        predictor_name=params['predictor'],
        mlp_hidden_dim=params['mlp_hidden_dim'],
        span_hidden_dim=params['span_hidden_dim'],
        video_if_mask=bool(params['mask']),
        remat=bool(params.get('remat', False)),
        dropout=params['dropout'],
        dtype=compute_dtype(params),
    )


def build_model(params: Dict[str, Any], kind: str = 'gmd',
                device: Union[str, torch.device] = 'cuda') -> nn.Module:
    """Build GMD (``kind`` 'gmd' or 'qave_match') or the QAVE baseline
    ('baseline' or 'qave') on the CPU with torch's default (seeded by the
    caller) initialisation, then move it to ``device``."""
    if kind.lower() in GMD_KINDS:
        model = GMD(m_temp=params['m_temp'],
                    # fixed in the reference driver (train.py:85)
                    m_temp_hidden=256, m_temp_layers=2,
                    m_pred_hidden=params['m_pred_hidden'],
                    m_pred_activ=params['m_pred_activ'],
                    disc_dropout=float(params.get('disc_dropout', 0.5)),
                    pseudo_ground=float(
                        params.get('loss_pseudo_ground_lambda', 0) or 0) > 0,
                    **model_config_from_params(params))
    elif kind.lower() in BASELINE_KINDS:
        model = Baseline(**model_config_from_params(params))
    else:
        raise ValueError(f'unknown model kind: {kind}')
    return model.to(device)
