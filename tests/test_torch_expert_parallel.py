"""The port's expert parallelism (``parallel/expert_parallel.py``) on the
CPU over gloo, against JAX's ``moe_ffn_sharded`` on the same mesh shapes
and against the dense oracle.

Sizes are ``tests/test_expert_parallel.py``'s (C=16, hidden 24, E=8,
capacity 6 a (rank, expert), S=64 tokens: a stripe of 16 a rank), the
tokens from a seed with numpy and the weights JAX's
``init_moe_params(PRNGKey(0))`` carried by ``utils/interop.
moe_params_from_jax``. One group of four ranks (``tests/dp_group.py``,
tasks in ``tests/mp_ranks.py``) is started for the module; JAX's
references run on its 8 virtual CPU devices meanwhile:

- 1x4 and 2x2 at capacity 6, and 2x2 at capacity 2 (tokens dropped):
  each rank's output, the input's gradient of sum(y ** 2), the router's
  (summed over every rank) and each rank's experts' (summed over the data
  axis) against JAX's ``jax.grad`` through its sharded layer and against
  the port's dense oracle striped, within 1e-5 (rtol and atol);
- ``moe_span_head`` at capacity 0 is the identity, on the ranks and
  dense, and at capacity 2 (drops) equals JAX's dense head;
- E that the expert axis does not divide raises JAX's message;
- ``init_moe_params`` draws JAX's shapes and ranges from a generator.
"""

import os

import numpy as np
import pytest
import torch

import dp_group
from torch_one_thread import one_torch_thread  # noqa: F401

from shufflingvideosfortsg_torch.parallel import expert_parallel as ep

C, HM, E, CAP, S = 16, 24, 8, 6, 64
TOL = 1e-5
# (name, dp, ep, capacity) of the cases the ranks run in turn
CASES = [('1x4', 1, 4, CAP), ('2x2', 2, 2, CAP), ('2x2_drops', 2, 2, 2)]


def _jax_setup():
    import jax
    from shufflingvideosfortsg_tpu.parallel import expert_parallel as J
    params = J.init_moe_params(jax.random.PRNGKey(0), C, HM, E)
    x = np.random.default_rng(5).standard_normal((S, C)).astype(np.float32)
    return params, x


def _jax_refs(params, x):
    """JAX's sharded layer on each case's mesh: (y, d_params, d_x)."""
    import jax
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.parallel import expert_parallel as J
    refs = {}
    for name, dp, n, cap in CASES:
        mesh = J.create_ep_mesh(dp, n)
        data_axis = None if dp == 1 else 'data'

        def loss(p, a):
            return jnp.sum(J.moe_ffn_sharded(p, a, mesh, cap,
                                             data_axis=data_axis) ** 2)
        y = jax.jit(lambda p, a: J.moe_ffn_sharded(
            p, a, mesh, cap, data_axis=data_axis))(params, jnp.asarray(x))
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params,
                                                          jnp.asarray(x))
        refs[name] = (np.asarray(y), jax.tree.map(np.asarray, gp),
                      np.asarray(gx))
    return refs


@pytest.fixture(scope='module')
def moe(tmp_path_factory):
    """(the ranks' results by case, JAX's references, the port's params
    and tokens), the ranks started here and waited for by the first test
    that asks."""
    import jax
    from shufflingvideosfortsg_torch.utils.interop import moe_params_from_jax
    root = str(tmp_path_factory.mktemp('torch_ep'))
    params, x = _jax_setup()
    pp = moe_params_from_jax(jax.tree.map(np.asarray, params))
    inputs = os.path.join(root, 'moe.pt')
    torch.save({'params': pp, 'x': torch.from_numpy(x)}, inputs)
    group = dp_group.launch(
        os.path.join(root, 'four'),
        [['mp_ranks:ep_moe', {'inputs': inputs, 'dp': dp, 'ep': n,
                              'capacity': cap}]
         for _, dp, n, cap in CASES], world=4)
    refs = _jax_refs(params, x)
    cache = {}

    def results():
        if not cache:
            per_rank = group.results()
            for i, (name, *_) in enumerate(CASES):
                cache[name] = sorted((r[i] for r in per_rank),
                                     key=lambda o: o['rank'])
        return cache

    return results, refs, pp, torch.from_numpy(x), params


def _dense_striped(pp, x, n, cap):
    """The oracle on each of n stripes (capacity a (rank, expert)), and
    the gradients of sum(y ** 2) in the parameters and the tokens."""
    q = {k: v.clone().requires_grad_() for k, v in pp.items()}
    a = x.clone().requires_grad_()
    y = torch.cat([ep.moe_ffn_dense(q, s, cap) for s in a.chunk(n)])
    (y ** 2).sum().backward()
    return y.detach(), {k: v.grad for k, v in q.items()}, a.grad


def _assemble(runs, dp, n):
    """The ranks' output and input gradient in token order, the router's
    gradient (every rank holds the whole sum) and the experts' (rank
    (d, k) holds rows [k E/n, (k+1) E/n), equal over d)."""
    y = torch.cat([r['y'] for r in runs])
    dx = torch.cat([r['dx'] for r in runs])
    El = E // n
    grads = {'router': runs[0]['grads']['router']}
    for name in ('w1', 'b1', 'w2', 'b2'):
        full = torch.zeros_like(runs[0]['grads'][name])
        for r in runs:
            d, k = divmod(r['rank'], n)
            rows = slice(k * El, (k + 1) * El)
            g = r['grads'][name]
            assert not g[:k * El].any() and not g[(k + 1) * El:].any()
            if d == 0:
                full[rows] = g[rows]
            else:  # the data axis summed them: every d holds the same
                torch.testing.assert_close(g[rows], full[rows], rtol=0,
                                           atol=0)
        grads[name] = full
    for r in runs[1:]:
        torch.testing.assert_close(r['grads']['router'], grads['router'],
                                   rtol=0, atol=0)
    return y, grads, dx


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize('ref', ['jax', 'dense'])
def test_sharded_moe_equals_jax_and_the_dense_oracle(moe, case, ref):
    results, refs, pp, x, _ = moe
    name, dp, n, cap = case
    y, grads, dx = _assemble(results()[name], dp, n)
    if ref == 'jax':
        wy, wg, wx = refs[name]
    else:
        wy, wg, wx = _dense_striped(pp, x, dp * n, cap)
        wg = {k: v.numpy() for k, v in wg.items()}
    _close(y, wy, f'{name} forward')
    _close(dx, wx, f'{name} d_x')
    for k in ('router', 'w1', 'b1', 'w2', 'b2'):
        _close(grads[k], wg[k], f'{name} d_{k}')


def test_capacity_drops_fall_back_to_the_identity(moe):
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.parallel import expert_parallel as J
    results, _, pp, x, params = moe
    for name, *_ in CASES:
        assert all(r['identity'] for r in results()[name]), name
    feat = x.reshape(4, S // 4, C)
    torch.testing.assert_close(ep.moe_span_head(pp, feat, 0), feat, rtol=0,
                               atol=0)
    # at capacity 2 some tokens drop: they keep their features, as JAX's
    got = ep.moe_span_head(pp, feat, 2)
    want = np.asarray(J.moe_span_head(params, jnp.asarray(feat.numpy()), 2))
    _close(got, want, 'moe_span_head at capacity 2')
    combine = ep._route(pp, x, 2)
    assert (combine.sum((1, 2)) == 0).any()  # some tokens were dropped


def test_indivisible_experts_raise():
    from shufflingvideosfortsg_torch.parallel.mesh import DataMesh, MeshAxis
    cpu = torch.device('cpu')
    mesh = DataMesh(0, 1, cpu, inner=MeshAxis('expert', 0, 3, None,
                                              [0, 1, 2], cpu))
    pp = ep.init_moe_params(torch.Generator().manual_seed(0), C, HM, E)
    with pytest.raises(ValueError, match="8 experts must divide the 3-way "
                       "'expert' axis"):
        ep.moe_ffn_sharded(pp, torch.zeros(48, C), mesh, CAP)


def test_init_moe_params_has_jax_shapes_and_ranges():
    pp = ep.init_moe_params(torch.Generator().manual_seed(3), C, HM, E)
    params, _ = _jax_setup()
    for k, v in params.items():
        assert tuple(pp[k].shape) == v.shape and pp[k].dtype == torch.float32
    for k, bound in (('router', C ** -0.5), ('w1', C ** -0.5),
                     ('w2', HM ** -0.5)):
        assert pp[k].abs().max() <= bound
        assert pp[k].abs().max() > 0.9 * bound
    assert not pp['b1'].any() and not pp['b2'].any()
    again = ep.init_moe_params(torch.Generator().manual_seed(3), C, HM, E)
    assert all(torch.equal(v, again[k]) for k, v in pp.items())
