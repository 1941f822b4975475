"""The port's pipe axis (``parallel/pipeline.py``, ``train/pipelined.py``)
on the CPU over gloo, against JAX's pipelined GMD.

Two ranks, started once for the module by ``tests/dp_group.py``, at
JAX's test sizes (B=8, T=16, N=7, D=32, H=16;
``tests/test_pipelined_train.py:24-35``), ``pipeline_stages`` 2 (QAVE 3
blocks deep), a (1, 2) mesh:

- (a) 2 updates in 4 microbatches, dropout 0, JAX's pseudo stream,
  against JAX's ``make_gmd_pipelined_train_step`` on
  ``create_pp_mesh(1, 2)`` and JAX's plain step: every metric rel 2e-4
  abs 2e-5, parameters (gathered to the sequential layout) rtol 3e-4 atol
  3e-6 (``test_pipelined_train.py:99-107``); the ranks bit for bit; each
  rank holds its stage alone, and the gathered optimizer state is the
  sequential one;
- (b) ``grad_accum_steps`` 2 against JAX's plain step at 2; the clip by
  the global norm over the stages against the one-process step;
- (c) ``qave_pipelined`` at two ranks: output and gradients against the
  port's ``QueryAwareEncoder``;
- (d) ``python -m shufflingvideosfortsg_torch.train --pipeline_stages 2``
  under torchrun: rank 0's checkpoint is in the sequential ``block1..k``
  layout, equal to the ranks' gathered weights, and JAX's
  ``load_checkpoint`` and the port's test driver read it;
- (e) ``stack_encoder_tail``/``unstack_encoder_tail`` round trip; JAX's
  refusals with JAX's messages (stage count, heterogeneous stages,
  microbatches, the CLI combinations and ``--remat``'s warning);
- (f) ``precision: bf16``: one pipelined update in 4 microbatches against
  JAX's GPipe step at bf16, at the bf16 bounds of a train step
  (``test_torch_tensor_parallel.hold_bf16_update``): JAX builds its
  stages and block 0 unfused (``lax.scan``, h and c in bf16) on every
  platform, the port runs them through K3/K4 (c in f32, the contract of
  JAX's Pallas kernels), so the four gradients named in PP_OWN_STEP may
  instead lie within 2^-5 relative L2 of the port's one-process bf16
  step (ROADMAP.md §3), every other one is held against JAX's; every
  gradient within 2^-5 of the one-process step; the ranks bit for bit
  where both hold a tensor.
"""

import json
import os

import numpy as np
import pytest
import torch

import dp_group
from test_torch_tensor_parallel import (LOSS_ABS, LOSS_REL, hold_bf16_update,
                                        jax_bf16_ref, jax_f32_grads, jax_run,
                                        pair_batch, save_inputs, tiny_corpus)
from torch_one_thread import one_torch_thread  # noqa: F401

STAGES, N_MICRO = 2, 4
P_RTOL, P_ATOL = 3e-4, 3e-6
def _over(**over):
    base = dict(pipeline_stages=STAGES)
    base.update(over)
    return base


def port_params(**over):
    import test_torch_tensor_parallel as ttp
    return ttp.port_params(**_over(**over))


def jax_params(**over):
    import test_torch_tensor_parallel as ttp
    return ttp.jax_params(**_over(**over))


def encoder_inputs(root):
    from shufflingvideosfortsg_torch.models.components import \
        QueryAwareEncoder
    torch.manual_seed(3)
    shape = (16, 8, 1, STAGES + 1, 16, 0.0)  # Dv, H, layers, nblocks, Ds
    enc = QueryAwareEncoder(*shape)
    rng = np.random.default_rng(3)
    path = os.path.join(root, 'encoder.pt')
    torch.save({'shape': shape, 'weights': enc.state_dict(),
                'video': torch.from_numpy(rng.standard_normal(
                    (8, 12, 16)).astype(np.float32)),
                'words': torch.from_numpy(rng.standard_normal(
                    (8, 5, 16)).astype(np.float32))}, path)
    return path


@pytest.fixture(scope='module')
def pp(tmp_path_factory):
    """The ranks' results by task, started here and waited for by the
    first test that asks; JAX's references computed meanwhile."""
    import jax
    from shufflingvideosfortsg_tpu import cli as jax_cli
    from shufflingvideosfortsg_tpu.models import build_model
    from shufflingvideosfortsg_tpu.parallel.pipeline import create_pp_mesh
    from shufflingvideosfortsg_tpu.train.pipelined import (
        make_gmd_pipelined_train_step, stack_encoder_tail,
        unstack_encoder_tail)
    from shufflingvideosfortsg_tpu.train.steps import make_gmd_train_step
    from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
    root = str(tmp_path_factory.mktemp('torch_pp'))
    params = jax_params()
    model = build_model(params, 'gmd')
    weights = jax.tree.map(np.asarray, jax_cli.init_model_params(
        model, params, jax.random.PRNGKey(0), 'gmd'))
    batch = pair_batch()
    sd = state_dict_from_jax(weights, nblocks=STAGES + 1)
    inputs = {'a': save_inputs(os.path.join(root, 'a.pt'), port_params(), sd,
                               batch),
              'b': save_inputs(os.path.join(root, 'b.pt'),
                               port_params(grad_accum_steps=2), sd, batch),
              'c': save_inputs(os.path.join(root, 'c.pt'),
                               port_params(grad_clip=True, grad_clip_max=0.5),
                               sd, batch),
              'bf16': save_inputs(os.path.join(root, 'bf16.pt'),
                                  port_params(precision='bf16'), sd, batch)}
    argv = tiny_corpus(root, ['--pipeline_stages', str(STAGES)])
    tasks = [
        ['mp_ranks:pp_steps', {'inputs': inputs['a'], 'dp': 1, 'pp': STAGES,
                               'n_micro': N_MICRO}],
        ['mp_ranks:pp_steps', {'inputs': inputs['b'], 'dp': 1, 'pp': STAGES,
                               'n_micro': N_MICRO}],
        ['mp_ranks:pp_steps', {'inputs': inputs['c'], 'dp': 1, 'pp': STAGES,
                               'n_micro': N_MICRO}],
        ['mp_ranks:pp_encoder', {'inputs': encoder_inputs(root),
                                 'pp': STAGES, 'n_micro': N_MICRO}],
        ['driver', {'argv': argv + ['--alias', 'pp_entry', '--epoch', '1'],
                    'entry': 'train', 'maker': 'make_gmd_pipelined_train_step',
                    'module': 'shufflingvideosfortsg_torch.train'}],
        ['mp_ranks:pp_steps', {'inputs': inputs['bf16'], 'dp': 1,
                               'pp': STAGES, 'n_micro': N_MICRO, 'n': 1,
                               'grads': True}]]
    group = dp_group.launch(os.path.join(root, 'ranks'), tasks)

    refs = {'plain': jax_run(model, params, weights, batch,
                             make_gmd_train_step(model, params))}
    mesh = create_pp_mesh(1, STAGES)
    piped = make_gmd_pipelined_train_step(model, params, mesh, N_MICRO,
                                          data_axis=None,
                                          train_dropout=False)
    stacked = stack_encoder_tail(weights, model.nblocks, mesh=mesh)
    refs['pipelined'] = jax_run(model, params, stacked, batch, piped,
                                to_sequential=unstack_encoder_tail)
    accum = jax_params(grad_accum_steps=2)
    refs['accum'] = jax_run(model, accum, weights, batch,
                            make_gmd_train_step(model, accum))
    bf16 = jax_params(precision='bf16')
    refs['bf16'] = jax_bf16_ref(
        make_gmd_pipelined_train_step(build_model(bf16, 'gmd'), bf16, mesh,
                                      N_MICRO, data_axis=None,
                                      train_dropout=False),
        bf16, stack_encoder_tail(weights, model.nblocks, mesh=mesh), batch,
        jax_f32_grads(model, params, weights, batch),
        to_sequential=unstack_encoder_tail)
    cache = {}

    def results():
        if not cache:
            names = ['steps', 'accum', 'clip', 'encoder', 'driver', 'bf16']
            per_rank = group.results()
            cache.update({n: [r[i] for r in per_rank]
                          for i, n in enumerate(names)})
        return cache

    return results, refs, inputs, argv, root


def _hold_metrics(got, want):
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=LOSS_REL,
                                       abs=LOSS_ABS), k


def _hold_params(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=P_RTOL,
                                   atol=P_ATOL, err_msg=k)


@pytest.mark.parametrize('ref', ['pipelined', 'plain'])
def test_pipelined_step_equals_jax(pp, ref):
    """(a) two pipelined updates in 4 microbatches at 1x2."""
    results, refs, _, _, _ = pp
    got = results()['steps'][0]
    metrics, params = refs[ref]
    _hold_metrics(got['metrics'][-1], metrics)
    _hold_params(got['weights'], params)


def test_pipelined_ranks_agree_and_hold_their_stage(pp):
    """(a) the ranks' metrics and gathered weights bit for bit; each rank
    holds block 0, its stage and the replicated parameters, not the other
    stage; the gathered optimizer state covers every parameter."""
    from shufflingvideosfortsg_torch.models.build import build_model
    results, _, _, _, _ = pp
    a, b = results()['steps']
    assert a['metrics'] == b['metrics']
    assert all(torch.equal(v, b['weights'][k])
               for k, v in a['weights'].items())
    model = build_model(port_params(), 'gmd', device='cpu')
    stage = sum(p.numel() for p in model.video_encoder.blocks[1].parameters())
    total = sum(p.numel() for p in model.parameters())
    assert a['resident'] == b['resident'] == total - stage
    for r in (a, b):
        assert len(r['sidecar']['optimizer']['state']) == \
            len(list(model.parameters()))


def test_pipelined_grad_accum_equals_jax(pp):
    """(b) grad_accum_steps 2 against JAX's plain step at 2."""
    results, refs, _, _, _ = pp
    got = results()['accum'][0]
    metrics, params = refs['accum']
    _hold_metrics(got['metrics'][-1], metrics)
    _hold_params(got['weights'], params)


def test_pipelined_clip_spans_the_stages(pp):
    """The clip's global norm over every stage (each rank's summed over the
    pipe axis): two clipped updates against the one-process step."""
    from test_torch_tensor_parallel import port_plain
    results, _, inputs, _, _ = pp
    got = results()['clip'][0]
    metrics, weights = port_plain(inputs['c'], 2)
    _hold_metrics(got['metrics'][-1], metrics[-1])
    _hold_params(got['weights'], weights)


def one_process_grads(inputs):
    """The port's one-process step's gradients on the inputs' whole
    batch."""
    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.train.state import TrainState
    from shufflingvideosfortsg_torch.train.steps import make_gmd_train_step
    data = torch.load(inputs, weights_only=False)
    model = build_model(data['params'], 'gmd', device='cpu')
    model.load_state_dict(data['weights'])
    state = TrainState(model, data['params'], steps_per_epoch=10)
    make_gmd_train_step(model, state, data['params'])(data['batch'], None)
    return {k: p.grad.clone() for k, p in model.named_parameters()}


# the gradients of the bf16 GPipe step that lie outside the bf16 rule
# against JAX's (its stages and block 0 unfused, h and c in bf16) at this
# test's widths: block 0's reverse input and recurrent weights and the
# TOD's context layer (ROADMAP.md §3, tests/bf16_axes_drift.py --jax)
PP_OWN_STEP = ('video_encoder.blocks.0.rnn_cell.lstm.weight_ih_l0_reverse',
               'video_encoder.blocks.0.rnn_cell.lstm.weight_hh_l0_reverse',
               'tod.foreback_context.0.weight', 'tod.foreback_context.0.bias')


def test_pipelined_bf16_step_equals_jax(pp):
    """(f) one pipelined update at ``precision: bf16`` in 4 microbatches
    against JAX's GPipe step at bf16: the gradients of the two ranks
    merged (each holds its stage's; both the rest, bit for bit), the
    gathered weights bit for bit."""
    results, refs, inputs, _, _ = pp
    a, b = results()['bf16']
    assert a['metrics'] == b['metrics']
    assert all(torch.equal(v, b['weights'][k])
               for k, v in a['weights'].items())
    shared = set(a['grads']) & set(b['grads'])
    assert all(torch.equal(a['grads'][k], b['grads'][k]) for k in shared)
    for rank, r in enumerate((a, b)):
        assert f'video_encoder.blocks.{1 + rank}.rnn_cell.lstm.' \
            'weight_hh_l0' in r['grads']
    from test_torch_bf16_train import GRAD_REL_L2, _rel_l2
    got = dict(a, grads={**b['grads'], **a['grads']})
    one = one_process_grads(inputs['bf16'])
    for k, g in got['grads'].items():
        assert _rel_l2(g.numpy(), one[k].numpy()) <= GRAD_REL_L2, k
    hold_bf16_update(got, refs['bf16'], one_process=one,
                     own_step=PP_OWN_STEP)


def test_qave_pipelined_equals_sequential(pp):
    """(c) the GPipe schedule's output and gradients (the inputs', block
    0's summed over the ranks, the norm's and each rank's stage's) against
    the sequential encoder."""
    from shufflingvideosfortsg_torch.models.components import \
        QueryAwareEncoder
    results, _, _, _, root = pp
    data = torch.load(os.path.join(root, 'encoder.pt'), weights_only=False)
    enc = QueryAwareEncoder(*data['shape'])
    enc.load_state_dict(data['weights'])
    video = data['video'].clone().requires_grad_()
    words = data['words'].clone().requires_grad_()
    out = enc(video, words)
    out.sin().sum().backward()
    want = {k: p.grad for k, p in enc.named_parameters()}
    for rank, got in enumerate(results()['encoder']):
        np.testing.assert_allclose(got['out'].numpy(), out.detach().numpy(),
                                   rtol=3e-5, atol=3e-6)
        for name, ref in (('d_video', video.grad), ('d_words', words.grad)):
            np.testing.assert_allclose(got[name].numpy(), ref.numpy(),
                                       rtol=3e-5, atol=3e-6, err_msg=name)
        assert f'blocks.{1 + rank}.rnn_cell.lstm.weight_hh_l0' in got['grads']
        for k, g in got['grads'].items():
            np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                       rtol=3e-5, atol=3e-6, err_msg=k)


def test_pipelined_checkpoint_is_sequential_and_both_drivers_read_it(pp):
    """(d) the trainer under torchrun: rank 0's checkpoint in the
    sequential layout, the ranks' gathered weights; JAX's
    ``load_checkpoint`` and the port's test driver read it."""
    from shufflingvideosfortsg_tpu.utils.saver import \
        load_checkpoint as jax_load
    from shufflingvideosfortsg_torch import cli
    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.utils.saver import load_checkpoint
    results, _, _, argv, root = pp
    runs = results()['driver']
    ckp = os.path.join(runs[0]['run'], 'model', 'pp_entry_00000.ckp')
    weights, resume, _ = load_checkpoint(ckp)
    params = cli.parse_params(argv, default_model='GMD')
    model = build_model(params, 'gmd', device='cpu')
    assert set(weights) == set(model.state_dict())
    assert any(k.startswith('video_encoder.blocks.2.') for k in weights)
    for r in runs:
        got, = r['weights']
        assert all(torch.equal(v, got[k]) for k, v in weights.items())
    assert resume['train_state']['step'] == 8
    payload, is_ref = jax_load(ckp, torch_convert_kwargs=dict(
        kind='gmd', nblocks=STAGES + 1))
    assert is_ref and set(payload['params']['video_encoder']) == {
        'block0', 'block1', 'block2', 'norm'}
    with open(os.path.join(runs[0]['run'], 'metrics.jsonl')) as f:
        assert [json.loads(x)['phase'] for x in f] == ['train', 'valid']
    submit = cli.main_test(cli.parse_params(
        argv + ['--alias', 'test_pp', '--start_from', ckp],
        default_model='GMD'))
    with open(submit) as f:
        rows = [x for v in json.load(f)['results'].values() for x in v]
    assert len(rows) == 32 and all(np.isfinite(x['score']) for x in rows)


# --- (e) layouts and JAX's refusals -----------------------------------------

def test_stack_unstack_roundtrip():
    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.train.pipelined import (
        is_pipelined_tree, stack_encoder_tail, unstack_encoder_tail)
    sd = build_model(port_params(), 'gmd', device='cpu').state_dict()
    stacked = stack_encoder_tail(sd, STAGES + 1)
    assert is_pipelined_tree(stacked) and not is_pipelined_tree(sd)
    assert stacked['video_encoder.tail.rnn_cell.lstm.weight_hh_l0'].shape[0] \
        == STAGES
    back = unstack_encoder_tail(stacked)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def _axis(n):
    from shufflingvideosfortsg_torch.parallel.mesh import MeshAxis
    return MeshAxis('pipe', 0, n, None, list(range(n)), torch.device('cpu'))


def test_stage_count_mismatch_raises():
    from shufflingvideosfortsg_torch.models.components import \
        QueryAwareEncoder
    from shufflingvideosfortsg_torch.parallel.pipeline import qave_pipelined
    enc = QueryAwareEncoder(16, 8, 1, 5, 16, 0.0)
    with pytest.raises(ValueError, match='mesh axis'):
        qave_pipelined(enc, torch.zeros(8, 12, 16), torch.zeros(8, 5, 16),
                       _axis(8), 2)


def test_pipelined_state_stage_count_mismatch_raises():
    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.train.pipelined import PipelinedState
    from shufflingvideosfortsg_torch.train.state import TrainState
    params = port_params()
    state = TrainState(build_model(params, 'gmd', device='cpu'), params, 10)
    with pytest.raises(ValueError, match='stages but the'):
        PipelinedState(state, _axis(4))


def test_heterogeneous_stages_raise():
    from shufflingvideosfortsg_torch.parallel.pipeline import \
        stack_stage_params
    a = {'w': torch.zeros(2, 3)}
    with pytest.raises(ValueError, match='homogeneous'):
        stack_stage_params([a, {'w': torch.zeros(2, 4)}])
    with pytest.raises(ValueError, match='treedef'):
        stack_stage_params([a, {'v': torch.zeros(2, 3)}])


def test_indivisible_microbatch_raises():
    from shufflingvideosfortsg_torch.models.components import \
        QueryAwareEncoder
    from shufflingvideosfortsg_torch.parallel.pipeline import pipeline_blocks
    block = QueryAwareEncoder(16, 8, 1, 2, 16, 0.0).blocks[1]
    with pytest.raises(ValueError, match='microbatch'):
        pipeline_blocks(block, torch.zeros(8, 12, 16), torch.zeros(8, 5, 16),
                        _axis(4), 3)


@pytest.mark.parametrize('over,match', [
    (dict(pipeline_stages=0), None),
    (dict(fsdp=True), 'does not compose with --fsdp'),
    (dict(multi_seed=2), 'does not compose with --multi_seed'),
    (dict(tensor_parallel=2), 'does not compose with --tensor_parallel'),
    (dict(), 'device count divisible')])
def test_pipeline_validate_as_jax(over, match):
    from shufflingvideosfortsg_torch import cli
    params = port_params(**over)
    if match is None:
        assert cli._pipeline_validate(params) == 0
        return
    with pytest.raises(ValueError, match=match):
        cli._pipeline_validate(params)


def test_pipeline_validate_warns_of_remat(monkeypatch, caplog):
    from shufflingvideosfortsg_torch import cli
    monkeypatch.setattr(cli, 'world_size', lambda: 4)
    with caplog.at_level('WARNING'):
        assert cli._pipeline_validate(port_params(remat=True)) == STAGES
    assert '--remat is ignored with --pipeline_stages' in caplog.text
