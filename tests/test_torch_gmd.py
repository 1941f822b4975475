"""GMD.eval_forward of the port against the JAX package's, at shared
weights carried by ``state_dict_from_jax``, and the reference checkpoint
format both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shufflingvideosfortsg_tpu.models import GMD as JaxGMD
from shufflingvideosfortsg_tpu.utils.torch_interop import (
    convert_to_reference_state_dict, save_reference_ckp)
from shufflingvideosfortsg_torch.config import load_config
from shufflingvideosfortsg_torch.models.build import build_model
from shufflingvideosfortsg_torch.models.gmd import GMD
from shufflingvideosfortsg_torch.utils.interop import (load_reference_ckp,
                                                       state_dict_from_jax)
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-5  # f32
W, HS, D, HV, MLP, MPRED = 20, 8, 12, 16, 8, 24
B, T, N = 4, 18, 7


def _jax_model(mask):
    return JaxGMD(sent_hidden=HS, sent_layers=2, video_hidden=HV,
                  video_layers=2, nblocks=2, cross_name='vs',
                  predictor_name='mlp', mlp_hidden_dim=MLP,
                  video_if_mask=mask, dropout=0.0, m_temp='none',
                  m_pred_hidden=MPRED, m_pred_activ='relu')


def _port_model(mask):
    return GMD(video_feature_dim=D, word_dim=W, sent_hidden=HS,
               sent_layers=2, video_hidden=HV, video_layers=2, nblocks=2,
               cross_name='vs', predictor_name='mlp', mlp_hidden_dim=MLP,
               video_if_mask=mask, m_temp='none', m_pred_hidden=MPRED,
               m_pred_activ='relu', dropout=0.0)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    video = rng.randn(B, T, D).astype(np.float32)
    query = rng.randn(B, N, W).astype(np.float32)
    vmask = (np.arange(T)[None] <= rng.randint(4, T, (B, 1))).astype(np.int32)
    smask = (np.arange(N)[None] <= rng.randint(2, N, (B, 1))).astype(np.int32)
    return video, query, vmask, smask


@pytest.fixture(scope='module')
def jax_params():
    model = _jax_model(False)
    ones_t = jnp.ones((2, T), jnp.int32)
    video = jnp.zeros((2, T, D), jnp.float32)
    variables = model.init(jax.random.PRNGKey(7), jnp.zeros((2, N, W)),
                           jnp.ones((2, N), jnp.int32), video, ones_t, video,
                           ones_t, *[ones_t] * 6)
    return jax.tree.map(np.asarray, variables['params'])


@pytest.mark.parametrize('mask', [False, True])
def test_eval_forward_matches_jax(jax_params, mask):
    video, query, vmask, smask = _inputs()
    jm = _jax_model(mask)
    want = jm.apply({'params': jax_params}, *map(jnp.asarray, (video, query,
                                                             vmask, smask)),
                    method=jm.eval_forward)
    port = _port_model(mask)
    port.load_state_dict(state_dict_from_jax(jax_params), strict=True)
    with torch.no_grad():
        got = port.eval().eval_forward(*map(torch.from_numpy,
                                            (video, query, vmask, smask)))
    assert set(got) == set(want) == {'start_prob', 'end_prob', 'match_prob'}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL, rtol=0, err_msg=k)


def test_reference_state_dict_loads_strictly(jax_params):
    """The JAX package's export (the reference .ckp keys) and the port's
    own mapping name and fill the same tensors."""
    ref = convert_to_reference_state_dict(jax_params, kind='gmd')
    ours = state_dict_from_jax(jax_params)
    port = _port_model(False)
    assert set(ref) == set(ours) == set(port.state_dict())
    port.load_state_dict({k: torch.tensor(v) for k, v in ref.items()},
                         strict=True)
    for k, v in ours.items():
        assert torch.equal(port.state_dict()[k], v), k


def test_reference_ckp_file_roundtrip(jax_params, tmp_path):
    path = str(tmp_path / 'ref.ckp')
    save_reference_ckp(jax_params, path, kind='gmd')
    port = _port_model(False)
    port.load_state_dict(load_reference_ckp(path), strict=True)
    for k, v in state_dict_from_jax(jax_params).items():
        assert torch.equal(port.state_dict()[k], v), k


def test_build_model_reads_the_config_and_refuses_what_is_not_ported():
    params = load_config('charades_cd_i3d.yml')
    params.update(video_feature_dim=D, sent_embedding_dim=W,
                  sent_rnn_hiddendim=HS, video_rnn_hiddendim=HV,
                  mlp_hidden_dim=MLP, m_pred_hidden=MPRED)
    model = build_model(params, 'gmd', device='cpu')
    assert set(model.state_dict()) == set(_port_model(False).state_dict())
    assert {k: v.shape for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in _port_model(False).state_dict().items()}
    # precision bf16 builds: bf16 compute, the same f32 weights
    bf16 = build_model(dict(params, precision='bf16'), 'gmd', device='cpu')
    assert bf16.dtype == torch.bfloat16 and model.dtype == torch.float32
    assert {k: (v.shape, v.dtype) for k, v in bf16.state_dict().items()} == \
        {k: (v.shape, v.dtype) for k, v in model.state_dict().items()}
    with torch.no_grad():
        out = bf16.eval().eval_forward(torch.randn(2, T, D),
                                       torch.randn(2, N, W))
    assert out['start_prob'].dtype == torch.float32
    assert out['match_prob'].dtype == torch.bfloat16
    # the baseline builds (tests/test_torch_baseline.py); unknown kinds raise
    assert not any(k.startswith(('csmm.', 'tod.'))
                   for k in build_model(params, 'baseline', device='cpu')
                   .state_dict())
    with pytest.raises(ValueError, match='unknown model kind'):
        build_model(params, 'graph', device='cpu')
    # every predictor JAX builds is ported; a name JAX does not know raises
    # JAX's error
    with pytest.raises(ValueError, match='unknown predictor'):
        build_model(dict(params, predictor='boundary'), 'gmd', device='cpu')
