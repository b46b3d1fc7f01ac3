"""The forest bank keeps the family's rules; its SDF is the port's."""
import math

import numpy as np
import torch

from portbench import worlds

LIMS = (-5.0, 5.0)


def bank(seed=3, n=16, pairs=4, size=128):
    gen = torch.Generator().manual_seed(seed)
    return worlds.forest_bank(gen, n, pairs, size, LIMS, LIMS, 0.4, "cpu")


def boxes(occ):
    """Connected boxes of a map's obstacle cells (4-neighbour labels)."""
    from scipy import ndimage

    lab, n = ndimage.label(occ)
    return [np.argwhere(lab == k + 1) for k in range(n)]


def test_pairs_are_far_apart_and_inside():
    _, start, goal = bank()
    diag = math.hypot(10.0, 10.0)
    assert bool(((goal - start).norm(dim=-1) >= worlds.DIST_FACTOR * diag).all())
    for p in (start, goal):
        assert bool((p >= -4.0).all() and (p <= 4.0).all())


def test_boxes_keep_the_family_rules():
    maps, start, goal = bank()
    patch_pts, patch_obs = worlds.clearance_patches(128, LIMS, 0.4)
    assert (patch_pts, patch_obs) == (18, 18)
    res = 10.0 / 128
    for i in range(maps.shape[0]):
        occ = (maps[i] == 0).numpy()
        found = boxes(occ)
        assert 1 <= len(found) <= 44
        for cells in found:
            h = cells[:, 0].max() - cells[:, 0].min() + 1
            w = cells[:, 1].max() - cells[:, 1].min() + 1
            assert h * w == len(cells) and 4 <= h <= 6 and 4 <= w <= 6
        # Boxes lie at least ceil(patch_obs / 2) pixels apart.
        for a in range(len(found)):
            for b in range(a + 1, len(found)):
                gap = np.abs(found[a][:, None] - found[b][None]).max(-1).min()
                assert gap > 9
        # No obstacle cell within the clearance square of a start or goal.
        for p in torch.cat([start[i], goal[i]]).numpy():
            col = math.ceil(-LIMS[0] / res + p[0] / res)
            row = math.ceil(-LIMS[0] / res - p[1] / res)
            assert not occ[max(0, row - 9):row + 9, max(0, col - 9):col + 9].any()


def test_sdf_equals_the_ports():
    from dgpmp2_tpu_torch.ops.sdf import sdf_from_occupancy

    maps, _, _ = bank(n=4)
    want = sdf_from_occupancy(maps, res=10.0 / 128)
    assert torch.equal(worlds.sdf_from_map(maps, 10.0 / 128), want)


def test_same_seed_same_bank():
    a, b = bank(seed=9), bank(seed=9)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(bank(seed=10)[0], a[0])
