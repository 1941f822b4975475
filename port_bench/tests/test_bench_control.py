"""On the card: each cell's control, the plain reference with TF32
products in place of the program (the nearest precision below the
configurations' f32), comes out not correct under the cell's limits."""

import pytest

from harness import check, common

SEEDS = (2 ** 31 + 31, 2 ** 31 + 32, 2 ** 31 + 33)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('workload', ['charades_cd_i3d.train',
                                      'anet_cd_i3d.eval',
                                      'anet_cd_i3d.serve'])
def test_tf32_control_fails(card, workload):
    import calibrate
    cell = common.Cell.load(workload)
    for seed in SEEDS:
        if cell.mix['kind'] == 'train':
            numbers = calibrate.train_control(cell, seed, card)
        else:
            numbers = calibrate.answers_control(cell, seed, card)
        correct, checks = check.judge(numbers, cell.limits)
        assert not correct, checks
