"""The port's sequence parallelism (``parallel/seq_parallel.py``) and the
grounder's ``set_video_sharded`` on the CPU, against the JAX package's
``lstm_flat_time_sharded``, ``bilstm_time_sharded`` and sharded grounder.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``; the port
drives n shards on the CPU from one process. Sizes are
``tests/test_seq_parallel.py``'s (T=32, B=4, H=8, D=16; gradients at
T=32, B=2, H=8; the grounder at T=40 on its tiny GMD), the inputs made
from a seed with numpy:

- n = 1, 2, 4, 8: outputs and final carries against JAX's at the same n,
  within 1e-6; the final carries against the output's boundary rows;
- a T that n does not divide raises JAX's message;
- 2 layers of ``bilstm_time_sharded`` against JAX's and against the
  port's ``ops/rnn.BiLSTM``, within 1e-5;
- d_xw and d_w_hh at n = 2, 4, 8 against JAX's one-device scan's and the
  port's n=1, within 1e-5;
- bf16 at n=4 against JAX's bf16 within 2e-3 (``PERF.md`` §2's CPU K1
  bound; the state and gates are bf16 on both sides);
- ``set_video_sharded`` over ``mesh_shape: [8]`` against JAX's and the
  port's ``set_video``: rnn0 within 1e-5 (f32 also at bf16, as JAX's),
  spans exact, scores rtol 1e-4 atol 1e-5 (at bf16: rnn0 within 2e-3,
  scores within two bf16 roundings, relative).
"""

import numpy as np
import pytest
import torch

from torch_one_thread import one_torch_thread  # noqa: F401
from test_torch_serving import (DV, JAX_CFG, N, J,  # noqa: F401
                                port_params, weights)

from shufflingvideosfortsg_torch.parallel.seq_parallel import (
    bilstm_time_sharded, lstm_flat_time_sharded)

T, B, H, D = 32, 4, 8, 16
TOL = 1e-6


def _inputs(seed=42, T_=T, B_=B, H_=H):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((T_, B_, 8 * H_)).astype(np.float32)
    w_hh = (rng.standard_normal((2, H_, 4 * H_)) * 0.1).astype(np.float32)
    return xw, w_hh


def _jax_sharded(xw, w_hh, n):
    import jax
    from shufflingvideosfortsg_tpu.parallel.mesh import create_mesh
    from shufflingvideosfortsg_tpu.parallel.seq_parallel import \
        lstm_flat_time_sharded as jax_sharded
    mesh = create_mesh([n])
    return [np.asarray(a, np.float32) for a in jax.jit(
        lambda a, b: jax_sharded(a, b, mesh))(xw, w_hh)]


def _port(xw, w_hh, n, dtype=torch.float32):
    out, h, c = lstm_flat_time_sharded(torch.from_numpy(xw).to(dtype),
                                       torch.from_numpy(w_hh), ['cpu'] * n)
    return out, h, c


@pytest.mark.parametrize('n', [1, 2, 4, 8])
def test_pipeline_equals_jax(n):
    xw, w_hh = _inputs()
    out, h, c = _port(xw, w_hh, n)
    assert len(out) == n and all(o.shape == (T // n, B, 2 * H) for o in out)
    want = _jax_sharded(xw, w_hh, n)
    for got, ref in zip((torch.cat(out), h, c), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_final_carries_are_the_boundary_rows():
    """The forward's final h is out[T-1, :, :H], the backward's out[0, :,
    H:]: the last chunk's and the first's."""
    xw, w_hh = _inputs()
    out, h, _ = _port(xw, w_hh, 8)
    np.testing.assert_array_equal(h[0].numpy(), out[-1][-1, :, :H].numpy())
    np.testing.assert_array_equal(h[1].numpy(), out[0][0, :, H:].numpy())


def test_indivisible_T_raises():
    xw, w_hh = _inputs(T_=T + 1)
    with pytest.raises(ValueError, match='T=33 must be a multiple of the '
                       "8-way 'data' mesh axis"):
        _port(xw, w_hh, 8)
    from shufflingvideosfortsg_tpu.parallel.mesh import create_mesh
    from shufflingvideosfortsg_tpu.parallel.seq_parallel import \
        lstm_flat_time_sharded as jax_sharded
    with pytest.raises(ValueError, match='T=33 must be a multiple of the '
                       "8-way 'data' mesh axis"):
        jax_sharded(xw, w_hh, create_mesh([8]))


def test_two_layers_equal_jax_and_the_bilstm():
    import jax
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.ops.rnn import BiLSTM as JaxBiLSTM
    from shufflingvideosfortsg_tpu.parallel.mesh import create_mesh
    from shufflingvideosfortsg_tpu.parallel.seq_parallel import \
        bilstm_time_sharded as jax_bilstm
    from shufflingvideosfortsg_torch.ops.rnn import BiLSTM
    from shufflingvideosfortsg_torch.utils.interop import bilstm_to_torch
    x = np.random.default_rng(42).standard_normal((B, T, D)).astype(
        np.float32)
    mod = JaxBiLSTM(hidden_size=H, num_layers=2, dropout=0.0)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    mesh = create_mesh([8])
    want = np.asarray(jax.jit(lambda p, a: jax_bilstm(p, a, mesh, 2))(
        params, jnp.transpose(jnp.asarray(x), (1, 0, 2))))
    sd = {}
    bilstm_to_torch(jax.tree.map(np.asarray, params), 'lstm', 2, sd)
    lstm = BiLSTM(D, H, 2)
    lstm.load_state_dict({k[len('lstm.'):]: v for k, v in sd.items()})
    with torch.no_grad():
        out = bilstm_time_sharded(lstm, torch.from_numpy(x).transpose(0, 1),
                                  ['cpu'] * 8)
        plain = lstm(torch.from_numpy(x))[0]
    got = torch.cat(out).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.transpose(1, 0, 2), plain.numpy(),
                               rtol=1e-5, atol=1e-5)


def _loss(out, h, c):
    return (sum((o ** 2).sum() for o in out) + (h ** 2).sum()
            + (c ** 2).sum())


def _port_grads(xw, w_hh, n):
    a = torch.from_numpy(xw).requires_grad_()
    b = torch.from_numpy(w_hh).requires_grad_()
    _loss(*lstm_flat_time_sharded(a, b, ['cpu'] * n)).backward()
    return a.grad.numpy(), b.grad.numpy()


@pytest.fixture(scope='module')
def jax_grads():
    """JAX's gradients through its one-device scans (the n=1 pipeline)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from shufflingvideosfortsg_tpu.parallel.seq_parallel import \
        lstm_flat_time_sharded as jax_sharded
    xw, w_hh = _inputs(seed=7, B_=2)
    m1 = Mesh(np.array(jax.devices()[:1]), ('data',))

    def loss(a, b):
        out, h, c = jax_sharded(a, b, m1)
        return jnp.sum(out ** 2) + jnp.sum(h ** 2) + jnp.sum(c ** 2)
    return xw, w_hh, [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(xw), jnp.asarray(w_hh))]


@pytest.mark.parametrize('n', [2, 4, 8])
def test_time_sharded_gradients(jax_grads, n):
    xw, w_hh, want = jax_grads
    got = _port_grads(xw, w_hh, n)
    one = _port_grads(xw, w_hh, 1)
    for g, w, o in zip(got, want, one):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, o, rtol=1e-5, atol=1e-5)


def test_bf16_equals_jax_bf16():
    import jax.numpy as jnp
    xw, w_hh = _inputs()
    xw_b = np.asarray(jnp.asarray(xw).astype(jnp.bfloat16))
    out, h, c = _port(xw, w_hh, 4, dtype=torch.bfloat16)
    assert out[0].dtype == h.dtype == torch.bfloat16
    want = _jax_sharded(xw_b, w_hh, 4)
    for got, ref in zip((torch.cat(out), h, c), want):
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=2e-3)


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
def test_set_video_sharded_equals_jax_and_set_video(weights, precision):
    """``mesh_shape: [8]`` on both sides, T=40 (8 chunks of 5)."""
    from shufflingvideosfortsg_torch.serving import MultiQueryGrounder
    _, params, sd, Jx = weights
    rng = np.random.RandomState(21)
    Tl = 40
    video = rng.randn(Tl, DV).astype(np.float32)
    queries = rng.randn(11, N, 300).astype(np.float32)
    cfg = dict(precision=precision, mesh_shape=[8])
    jg = Jx.Grounder(dict(JAX_CFG, **cfg), params, query_batch=8)
    pg = MultiQueryGrounder(port_params(**cfg), sd, device='cpu',
                            query_batch=8)
    assert len(pg.replicas) == 8
    jg.set_video_sharded(video)
    pg.set_video_sharded(video)
    rnn0 = pg._resident_rnn0
    assert rnn0.dtype == torch.float32 and rnn0.shape == (1, Tl, 16)
    tol = dict(rtol=1e-5, atol=1e-5) if precision == 'f32' else \
        dict(rtol=0, atol=2e-3)
    np.testing.assert_allclose(rnn0.numpy(), np.asarray(jg._resident_rnn0),
                               **tol)
    got = pg.ground(None, queries)
    want = jg.ground(None, queries)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    # at bf16 the served batch rounds at bf16 (tests/test_torch_bf16.py's
    # SCORE_RTOL: two bf16 roundings, relative)
    np.testing.assert_allclose(
        got[1], np.asarray(want[1]),
        **(dict(rtol=1e-4, atol=1e-5) if precision == 'f32'
           else dict(rtol=2 * 2.0 ** -8, atol=0)))
    if precision == 'f32':
        one = MultiQueryGrounder(port_params(), sd, device='cpu',
                                 query_batch=8)
        one.set_video(video)
        np.testing.assert_allclose(rnn0.numpy(),
                                   one._resident_rnn0.numpy(), rtol=1e-5,
                                   atol=1e-5)
        ref = one.ground(None, queries)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-5)


def test_set_video_sharded_needs_block_0s_recurrence(weights):
    """An encoder without QAVE's block 0 (the RNN encoder) raises a clear
    error, where JAX's grounder meets a KeyError."""
    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.serving import MultiQueryGrounder
    params = port_params(video_encoder='rnn', mesh_shape=[2])
    sd = build_model(params, 'gmd', device='cpu').state_dict()
    g = MultiQueryGrounder(params, sd, device='cpu', query_batch=8)
    with pytest.raises(ValueError, match="QAVE's block-0 recurrence"):
        g.set_video_sharded(np.zeros((8, DV), np.float32))
