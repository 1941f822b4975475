"""GMD evaluation driver of the PyTorch port.

    python -m shufflingvideosfortsg_torch.test --cfg charades_cd_i3d.yml \\
        --alias test_<name> --start_from <reference .ckp> [--device cpu]

Like the root ``test.py``: loads ``--start_from`` (a reference torch
``.ckp``), writes the submit JSON and prints the retrieval table. Runs on
the CUDA card unless ``--device cpu`` is given.
"""

from .cli import main_test, parse_params

if __name__ == '__main__':
    main_test(parse_params(default_model='GMD'))
    print('Testing finished successfully!')
