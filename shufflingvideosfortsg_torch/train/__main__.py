"""GMD training driver of the PyTorch port.

    python -m shufflingvideosfortsg_torch.train --cfg charades_cd_i3d.yml \\
        --alias <name> [--epoch N] [--device cpu]

Like the root ``train.py``: trains GMD with the reference's four-term
loss, validates every ``test_interval`` epochs and writes a reference
``.ckp`` under ``<runs>/<alias>/model/``. Runs on the CUDA card unless
``--device cpu`` is given.
"""

from ..cli import main_train, parse_params

if __name__ == '__main__':
    main_train(parse_params(default_model='GMD'))
    print('Training finished successfully!')
