"""QAVE baseline evaluation driver of the PyTorch port.

    python -m shufflingvideosfortsg_torch.test_baseline \\
        --cfg charades_cd_i3d.yml --alias test_<name> \\
        --start_from <reference .ckp> [--device cpu]

Like the root ``test_baseline.py``: loads ``--start_from`` (a reference
torch ``.ckp`` of the baseline), writes the submit JSON and prints the
retrieval table. Runs on the CUDA card unless ``--device cpu`` is given.
"""

from .cli import main_test_baseline, parse_params

if __name__ == '__main__':
    main_test_baseline(parse_params(default_model='QAVE'))
    print('Testing finished successfully!')
