"""The JAX references of tests/test_torch_variants.py and
tests/test_torch_remat.py, computed in child processes running side by
side.

Each reference is a whole JAX model (GMD or the baseline, in a variant a
config selects) traced and compiled on the CPU as JAX's own
``tests/test_variants.py`` runs it (``fused`` off, every BiLSTM through
``lax.scan``): a few seconds of tracing and XLA compilation each, and
some twenty seconds for a train step's gradient. :class:`Children`
computes the groups of references a test module names in one child
process a group, all started together while the module's other tests
run, each pickling its references as numpy arrays (bf16 ones keep their
dtype) into the test's temporary directory; a child that passes its
deadline is killed and the fixture fails. The weights are drawn with
numpy from seeds into the shapes of ``jax.eval_shape(model.init)`` and
returned beside the outputs.

Not a test module (pytest collects ``test_*.py`` only). A child runs this
file as a script::

    python tests/variant_refs.py <output.pkl> <job> [<job> ...]
"""

import os
import pickle
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update('jax_platforms', 'cpu')  # as tests/conftest.py

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)
for _p in (_ROOT, _TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

W, D, H, MLP, SPAN, MPRED, MTEMP = 20, 12, 8, 8, 8, 16, 16
B, T, N = 4, 12, 5
# a child's deadline: the references take 10-30 s on a loaded host
DEADLINE_S = 300

# the chip's V1 and V2 (chip_smoke.py [variants]; V1's remat, which no
# forward without gradients reaches, is held by tests/test_torch_remat.py)
# and the baseline's other predictors (its V3), these over the cheaper RNN
# video encoder; mlp, 'vs', CSMM 'none' and QAVE with them are held by
# tests/test_torch_gmd.py and tests/test_torch_baseline.py
V1 = dict(predictor_name='cat_condi_lstm', m_temp='lstm', cross_name='tall',
          video_if_mask=True)
V2 = dict(video_encoder_name='rnn', predictor_name='self_attn',
          cross_name='a')
CASES = {'V1': ('gmd', V1), 'V2': ('gmd', V2),
         **{p: ('baseline', dict(video_encoder_name='rnn', predictor_name=p,
                                 video_if_mask=True))
            for p in ('tied_lstm', 'cat_tied_lstm', 'condi_lstm')},
         'conv': ('baseline', dict(predictor_name='conv', video_if_mask=True)),
         'rnn_conv': ('baseline', dict(video_encoder_name='rnn',
                                       predictor_name='conv'))}
# the GMD train steps held against the port's (flat config keys)
TRAIN_CONFIGS = {
    'V1': dict(predictor='cat_condi_lstm', m_temp='lstm', crossmodal='tall',
               remat=True, video_rnn_hiddendim=8),
    'V2': dict(video_encoder='rnn', predictor='self_attn', crossmodal='a'),
}


def shared(kind, **over):
    """The constructor arguments JAX's and the port's models share."""
    kw = dict(sent_hidden=H, sent_layers=2, video_hidden=H, video_layers=2,
              nblocks=2, cross_name='vs', predictor_name='mlp',
              mlp_hidden_dim=MLP, span_hidden_dim=SPAN, video_if_mask=False,
              dropout=0.0)
    if kind == 'gmd':
        kw.update(m_temp='none', m_temp_hidden=MTEMP, m_temp_layers=2,
                  m_pred_hidden=MPRED, m_pred_activ='relu')
    kw.update(over)
    return kw


def init_args(kind, T=T, N=N, D=D, W=W):
    """Dummy inputs of ``model.init``: GMD's pair forward or the
    baseline's."""
    video = jnp.zeros((2, T, D))
    ones_t, ones_n = jnp.ones((2, T), jnp.int32), jnp.ones((2, N), jnp.int32)
    if kind == 'gmd':
        return (jnp.zeros((2, N, W)), ones_n, video, ones_t, video, ones_t,
                *[ones_t] * 6)
    return video, jnp.zeros((2, N, W)), ones_t, ones_n


def fill(shapes, seed):
    """Weights of ``shapes`` (a tree of ShapeDtypeStructs) from numpy:
    kernels U(-1, 1)/sqrt(fan_in), biases U(-0.2, 0.2), LayerNorm scales
    1 + U(-0.1, 0.1)."""
    rng = np.random.RandomState(seed)

    def one(path, s):
        name = path[-1].key
        u = rng.uniform(-1, 1, s.shape)
        if name == 'scale':
            return (1 + 0.1 * u).astype(np.float32)
        if len(s.shape) >= 2 and not name.startswith('b_'):
            return (u / np.sqrt(s.shape[-2])).astype(np.float32)
        return (0.2 * u).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, shapes)


def inputs(seed=0, batch=B):
    """(video [batch, T, D], query [batch, N, W], video mask) from numpy."""
    rng = np.random.RandomState(seed)
    video = rng.randn(batch, T, D).astype(np.float32)
    query = rng.randn(batch, N, W).astype(np.float32)
    vmask = (np.arange(T)[None] <= rng.randint(4, T, (batch, 1))
             ).astype(np.int32)
    return video, query, vmask


def eval_ref(case, precision):
    """JAX's ``eval_forward`` of ``CASES[case]`` at ``precision`` (XLA's
    excess precision off) on ``inputs(seed)``: (weights, outputs), the
    seed 0 in f32 and 1 in bf16."""
    from shufflingvideosfortsg_tpu.models import Baseline, GMD
    import shufflingvideosfortsg_tpu.ops.attention as jax_attention
    import shufflingvideosfortsg_tpu.ops.rnn as jax_rnn
    from jax_cpu import _no_excess, _WidenedEinsum
    kind, over = CASES[case]
    seed = 0 if precision == 'f32' else 1
    dtype = jnp.float32 if precision == 'f32' else jnp.bfloat16
    if precision == 'bf16':  # the BiLSTM's and the attention's einsums
        jax_rnn.jnp = jax_attention.jnp = _WidenedEinsum()
    jm = (GMD if kind == 'gmd' else Baseline)(dtype=dtype,
                                             **shared(kind, **over))
    weights = fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                  *init_args(kind))['params'], seed)
    method = jm.eval_forward if kind == 'gmd' else None

    def fn(p, v, q, m):
        return jm.apply({'params': p}, v, q, m, method=method)
    out = _no_excess(fn, weights, *map(jnp.asarray, inputs(seed)))
    return weights, {k: np.asarray(v) for k, v in out.items()}


def train_ref(config):
    """The loss terms and gradients of JAX's GMD train step in
    ``TRAIN_CONFIGS[config]`` at tests/test_torch_train.py's widths and
    batch, dropout 0: (weights, aux, gradients). JAX runs without
    ``nn.remat`` (the same function, a third of the compile time)."""
    from shufflingvideosfortsg_tpu.models import build_model
    from shufflingvideosfortsg_tpu.train.steps import make_gmd_train_step
    from test_torch_train import _batch, _jax_pseudo, _params
    params = _params(**TRAIN_CONFIGS[config])
    jm = build_model(dict(params, remat=False), 'gmd')
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *init_args(
        'gmd', params['video_len'], params['sent_len'],
        params['video_feature_dim'], 300))
    weights = fill(shapes['params'], 11)
    b = _batch(n_words=params['sent_len'])
    step = make_gmd_train_step(jm, params)
    (_, aux), grads = jax.jit(jax.value_and_grad(step.loss_fn, has_aux=True))(
        weights, {k: jnp.asarray(v) for k, v in b.items()}, _jax_pseudo(b),
        jax.random.PRNGKey(0))
    return (weights, {k: np.asarray(v) for k, v in aux.items()},
            jax.tree.map(np.asarray, grads))


def compute(jobs):
    """{job: reference} for jobs 'eval:<case>:<precision>' and
    'train:<config>'."""
    refs = {}
    for job in jobs:
        what, *args = job.split(':')
        refs[job] = (eval_ref if what == 'eval' else train_ref)(*args)
    return refs


class Children:
    """:func:`compute` of each group of jobs in a child process of its own
    (this file run as a script), all started at once, each writing its
    pickle into ``tmp_dir``. A test module starts them in a fixture and
    runs its tests that need no reference while they work; :meth:`wait`
    gives the union of their references. A child that has not ended
    within ``deadline`` seconds of the wait's start is killed with its
    process group, and the wait raises, as it does when a child fails;
    :meth:`close` kills any child still running."""

    def __init__(self, groups, tmp_dir):
        self.procs = []
        for i, jobs in enumerate(groups):
            out = os.path.join(str(tmp_dir), f'variant_refs_{i}.pkl')
            self.procs.append((out, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), out, *jobs],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                start_new_session=True)))

    def wait(self, deadline: float = DEADLINE_S):
        refs, failed = {}, []
        try:
            for out, proc in self.procs:
                jobs = proc.args[3:]
                try:
                    log, _ = proc.communicate(timeout=deadline)
                except subprocess.TimeoutExpired:
                    failed.append(f'{jobs}: not done within {deadline} s')
                    continue
                if proc.returncode:
                    failed.append(f'{jobs}: exit {proc.returncode}\n'
                                  f'{log[-4000:]}')
                    continue
                with open(out, 'rb') as f:
                    refs.update(pickle.load(f))
        finally:
            self.close()
        if failed:
            raise RuntimeError('the JAX references failed: '
                               + '\n'.join(failed))
        return refs

    def close(self):
        for _, proc in self.procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()


if __name__ == '__main__':
    result = compute(sys.argv[2:])
    with open(sys.argv[1] + '.tmp', 'wb') as f:
        pickle.dump(result, f)
    os.replace(sys.argv[1] + '.tmp', sys.argv[1])
