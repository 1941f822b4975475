"""What a rank of the model-, pipe- and expert-axis CPU tests runs
(``tests/test_torch_tensor_parallel.py``, ``tests/test_torch_pipeline.py``,
``tests/test_torch_expert_parallel.py``), started by ``tests/dp_group.py``
as ``mp_ranks:<task>``. Each task reads
its inputs (a ``torch.save`` of params, weights and a batch) and returns
what the test holds: a rank's metrics, weights and gradients.

Not a test module (pytest collects ``test_*.py`` only).
"""

import torch

from dp_group import _clone


def _setup(inputs, mesh):
    """(params, model on the CPU from the inputs' weights, state on the
    mesh's data column, this rank's rows r, r + dp, ... of the batch)."""
    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.parallel.mesh import replicate_state
    from shufflingvideosfortsg_torch.train.state import TrainState
    data = torch.load(inputs, weights_only=False)
    params = data['params']
    model = build_model(params, 'gmd', device='cpu')
    model.load_state_dict(data['weights'], strict=True)
    state = TrainState(model, params, steps_per_epoch=10)
    state.mesh = mesh
    replicate_state(mesh, state)
    rows = {k: v[mesh.rank::mesh.world] for k, v in data['batch'].items()}
    return params, model, state, rows


def _run(step, state, rows, n, generator_seed, model=None):
    """``n`` updates; with ``model``, also the gradients of the last that
    this rank holds (after the step's reductions), by parameter name."""
    gen = (None if generator_seed is None
           else torch.Generator().manual_seed(generator_seed))
    metrics = [step(rows, gen) for _ in range(n)]
    out = {'metrics': [{k: float(v) for k, v in m.items()}
                       for m in metrics],
           'weights': _clone(state.weights())}
    if model is not None:
        out['grads'] = {k: p.grad.detach().clone()
                        for k, p in model.named_parameters()
                        if p.grad is not None and p.numel()}
    return out


def tp_steps(inputs, dp, mp, n=2, generator_seed=None, train_dropout=False,
             grads=False):
    """``n`` tensor-parallel GMD updates on a (dp, mp) mesh (``grads``:
    and the last one's gradients)."""
    from shufflingvideosfortsg_torch.parallel.tensor_parallel import \
        create_tp_mesh
    from shufflingvideosfortsg_torch.train.tp import make_gmd_tp_train_step
    mesh = create_tp_mesh(dp, mp, 'cpu')
    params, model, state, rows = _setup(inputs, mesh)
    step = make_gmd_tp_train_step(model, state, params, mesh,
                                  train_dropout=train_dropout)
    return _run(step, state, rows, n, generator_seed,
                model if grads else None)


def pp_steps(inputs, dp, pp, n_micro, n=2, generator_seed=None,
             train_dropout=False, grads=False):
    """``n`` pipelined GMD updates on a (dp, pp) mesh in ``n_micro``
    microbatches; the rank's resident parameter count and its gathered
    trainer state (``grads``: and the gradients of the last update that
    the rank holds, its stage's and the replicated parameters')."""
    from shufflingvideosfortsg_torch.parallel.pipeline import create_pp_mesh
    from shufflingvideosfortsg_torch.train.pipelined import (
        make_gmd_pipelined_train_step, to_pipelined_state,
        to_sequential_state)
    mesh = create_pp_mesh(dp, pp, 'cpu')
    params, model, state, rows = _setup(inputs, mesh)
    to_pipelined_state(state, mesh)
    step = make_gmd_pipelined_train_step(model, state, params, mesh, n_micro,
                                         train_dropout=train_dropout)
    out = _run(step, state, rows, n, generator_seed, model if grads else None)
    out['resident'] = sum(p.numel() for p in model.parameters())
    _, out['sidecar'] = to_sequential_state(state)
    return out


def tp_bilstm(inputs, mp):
    """``bilstm_hidden_sharded`` over an mp-way model axis: its output and
    the gradients of sum(sin(out)) in the input and the weights (the
    weights' summed over the axis)."""
    from shufflingvideosfortsg_torch.ops.rnn import BiLSTM
    from shufflingvideosfortsg_torch.parallel.tensor_parallel import (
        bilstm_hidden_sharded, create_tp_mesh)
    axis = create_tp_mesh(1, mp, 'cpu').inner
    data = torch.load(inputs, weights_only=False)
    lstm = BiLSTM(*data['shape'])
    lstm.load_state_dict(data['weights'])
    x = data['x'].clone().requires_grad_()
    out = bilstm_hidden_sharded(lstm, x, axis)
    out.sin().sum().backward()
    axis.sum_grads(lstm.parameters())
    return {'out': out.detach(), 'dx': x.grad,
            'grads': {k: p.grad for k, p in lstm.named_parameters()}}


def pp_encoder(inputs, pp, n_micro):
    """``qave_pipelined`` over a pp-way pipe axis: its output and the
    gradients of sum(sin(out)) in the inputs, block 0 (summed over the
    axis), the norm and this rank's stage."""
    from shufflingvideosfortsg_torch.models.components import \
        QueryAwareEncoder
    from shufflingvideosfortsg_torch.parallel.pipeline import (
        create_pp_mesh, qave_pipelined)
    axis = create_pp_mesh(1, pp, 'cpu').inner
    data = torch.load(inputs, weights_only=False)
    enc = QueryAwareEncoder(*data['shape'])
    enc.load_state_dict(data['weights'])
    video = data['video'].clone().requires_grad_()
    words = data['words'].clone().requires_grad_()
    out = qave_pipelined(enc, video, words, axis, n_micro)
    out.sin().sum().backward()
    axis.sum_grads(enc.blocks[0].parameters())
    stage = f'blocks.{1 + axis.rank}.'
    return {'out': out.detach(), 'd_video': video.grad, 'd_words': words.grad,
            'grads': {k: p.grad for k, p in enc.named_parameters()
                      if p.grad is not None and (
                          not k.startswith('blocks.') or
                          k.startswith('blocks.0.') or k.startswith(stage))}}


def ep_moe(inputs, dp, ep, capacity):
    """``moe_ffn_sharded`` over a (dp, ep) expert mesh on this rank's token
    stripe r = d * ep + k of the inputs' x: its output, the gradients of
    sum(y ** 2) in the stripe, the router (summed over every rank) and the
    expert weights (each rank's rows, summed over the data axis), and
    ``moe_span_head`` at capacity 0 on the stripe (every token dropped)."""
    from shufflingvideosfortsg_torch.parallel.expert_parallel import (
        create_ep_mesh, moe_ffn_sharded, moe_span_head)
    mesh = create_ep_mesh(dp, ep, 'cpu')
    r = mesh.rank * ep + mesh.inner.rank
    data = torch.load(inputs, weights_only=False)
    params = {k: v.clone().requires_grad_()
              for k, v in data['params'].items()}
    stripe = data['x'].shape[0] // (dp * ep)
    x = data['x'][r * stripe:(r + 1) * stripe].clone().requires_grad_()
    y = moe_ffn_sharded(params, x, mesh, capacity)
    (y ** 2).sum().backward()
    feat = x.detach().reshape(2, stripe // 2, -1)
    head = moe_span_head(data['params'], feat, 0, mesh)
    return {'rank': r, 'y': y.detach(), 'dx': x.grad,
            'grads': {k: p.grad for k, p in params.items()},
            'identity': torch.equal(head, feat)}
