"""QAVE baseline training driver of the PyTorch port.

    python -m shufflingvideosfortsg_torch.train_baseline \\
        --cfg charades_cd_i3d.yml --alias <name> [--epoch N] [--device cpu]

Like the root ``train_baseline.py``: trains the QAVE baseline on the
grounding loss alone, validates every ``test_interval`` epochs and writes
a reference ``.ckp`` under ``<runs>/<alias>/model/``. Runs on the CUDA
card unless ``--device cpu`` is given.
"""

from .cli import main_train_baseline, parse_params

if __name__ == '__main__':
    main_train_baseline(parse_params(default_model='QAVE'))
    print('Training finished successfully!')
