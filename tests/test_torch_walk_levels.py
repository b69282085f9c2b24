"""The tree-level order that kernel K3 walks, as packed into the kernels'
table (``fk_kernel.pack_system``), on the CPU.

K3's lanes take the bodies of one level at once, so the packed order must
hold every body but the world once, with each body's parent in an earlier
level (or the world). The kernel itself runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 4).
"""
import ctypes
import dataclasses

import numpy as np
import pytest

from cadm_tpu_torch.envs.rigid_base import ASSETS, load_system
from cadm_tpu_torch.ops import fk_kernel

# bodies per level below the world body, from the assets' trees
LEVEL_SIZES = {"half_cheetah": [1, 2, 2, 2], "hopper": [1, 1, 1, 1],
               "ant": [1, 4, 4, 4], "slim_humanoid": [1, 3, 3, 2, 2, 2]}


def packed_levels(sys_):
    """The levels as the packed table holds them."""
    t = fk_kernel.pack_system(sys_)
    starts = list(t.level_start)[: t.n_levels + 1]
    return [list(t.level_body)[a:b] for a, b in zip(starts, starts[1:])]


@pytest.mark.parametrize("asset", ASSETS)
def test_packed_level_order_holds_every_body_once(asset):
    sys_ = load_system(asset)
    order = [b for level in packed_levels(sys_) for b in level]
    assert sorted(order) == list(range(1, sys_.nb))


@pytest.mark.parametrize("asset", ASSETS)
def test_each_parent_sits_in_an_earlier_level(asset):
    sys_ = load_system(asset)
    level_of = {0: -1}  # the world body, where the walk starts
    for lvl, level in enumerate(packed_levels(sys_)):
        for b in level:
            level_of[b] = lvl
    for b in range(1, sys_.nb):
        assert level_of[int(sys_.body_parent[b])] == level_of[b] - 1, b


@pytest.mark.parametrize("asset", ASSETS)
def test_level_sizes(asset):
    levels = packed_levels(load_system(asset))
    assert [len(level) for level in levels] == LEVEL_SIZES[asset]


@pytest.mark.parametrize("asset", ASSETS)
def test_sys_table_holds_the_computed_levels(asset):
    """The table stays a whole number of 16-byte words (the kernels copy it
    as int4) and its level fields are walk_levels', zero past the end."""
    sys_ = load_system(asset)
    assert ctypes.sizeof(fk_kernel.SysTable) % 16 == 0
    t = fk_kernel.pack_system(sys_)
    levels = fk_kernel.walk_levels(sys_)
    n = len(levels)
    assert t.n_levels == n
    starts = np.cumsum([0] + [len(x) for x in levels]).tolist()
    assert list(t.level_start) == starts + [0] * (fk_kernel.NB_MAX - n - 1)
    assert list(t.level_body) == [b for x in levels for b in x] \
        + [0] * (fk_kernel.NB_MAX - sys_.nb + 1)


def test_walk_levels_rejects_a_parent_after_its_body():
    """The serial walk (K2) goes in body order, so a parent must precede
    its body; the packing refuses a tree that breaks this."""
    sys_ = load_system("hopper")
    parent = np.array(sys_.body_parent)
    parent[2], parent[3] = 3, 1  # body 2 now hangs from body 3
    with pytest.raises(ValueError, match="does not precede"):
        fk_kernel.pack_system(dataclasses.replace(sys_, body_parent=parent))
