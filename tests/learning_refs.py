"""JAX's side of tests/test_torch_learning.py's learning check, in a
child process with a deadline.

JAX's QAVE baseline trained through the JAX package's own driver
(``cli.main_train_baseline``) on the corpus and vocabulary the port's
side trains on, at ``tests/test_learning.py``'s dims: its per-epoch
validation mIoU, written as JSON. The child runs while the port's tests
run; :func:`start` launches it and :meth:`Child.result` waits (240 s
deadline, then a fresh child once), as ``tests/bf16_train_refs.py`` does
for its references.

Not a test module (pytest collects ``test_*.py`` only)::

    python tests/learning_refs.py <spec.json> <out.json>
"""

import json
import os
import signal
import subprocess
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)
DEADLINE_S = 240
ATTEMPTS = 2


class Child:
    """A started child: :meth:`result` waits for it (restarting it once
    past its deadline) and returns what it wrote."""

    def __init__(self, spec_path: str, out: str):
        self.spec_path, self.out = spec_path, out
        self.attempt = 0
        self._start()

    def _start(self):
        self.attempt += 1
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), self.spec_path,
             self.out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True,
            env=dict(os.environ, JAX_PLATFORMS='cpu'))

    def result(self):
        while True:
            try:
                log, _ = self.proc.communicate(timeout=DEADLINE_S)
                break
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)
                self.proc.communicate()
                if self.attempt >= ATTEMPTS:
                    raise RuntimeError(f'JAX\'s training did not finish '
                                       f'within {DEADLINE_S} s, twice')
                self._start()
        if self.proc.returncode:
            raise RuntimeError(f'JAX\'s training failed (exit '
                               f'{self.proc.returncode}):\n{log[-4000:]}')
        with open(self.out) as f:
            return json.load(f)


def start(tmp_dir, overrides) -> Child:
    """Start the child on ``overrides`` of ``cfgs/charades_cd_i3d.yml``
    (paths absolute)."""
    spec = os.path.join(str(tmp_dir), 'jax_learning_spec.json')
    with open(spec, 'w') as f:
        json.dump(overrides, f)
    return Child(spec, os.path.join(str(tmp_dir), 'jax_learning.json'))


def train(overrides):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, _ROOT)
    from shufflingvideosfortsg_tpu import cli
    from shufflingvideosfortsg_tpu.config import load_config
    params = load_config(os.path.join(_ROOT, 'cfgs', 'charades_cd_i3d.yml'),
                         overrides=overrides)
    stats = cli.main_train_baseline(params)
    return {'mIoU': {str(k): v for k, v in stats['mIoU'].items()}}


if __name__ == '__main__':
    with open(sys.argv[1]) as f:
        res = train(json.load(f))
    with open(sys.argv[2] + '.tmp', 'w') as f:
        json.dump(res, f)
    os.replace(sys.argv[2] + '.tmp', sys.argv[2])
