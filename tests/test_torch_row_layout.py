"""The row layout shared by kernels K2 and K3, on the CPU.

K2 writes one row per env with every field the physics step reads; K3
writes the first nine (FK) fields of the same layout. ``row_fields`` and
``_fkvel_from_rows`` turn rows into views. Here the rows are packed by hand
from ``full_dyn_plain``'s outputs, so no kernel is needed.
"""
import numpy as np
import pytest
import torch

from cadm_tpu_torch.envs.rigid_base import ASSETS, load_system
from cadm_tpu_torch.ops import fk_kernel

FK_NINE = ("pos", "quat", "com", "omega", "v_com", "alpha0", "a_com0",
           "dof_axis", "dof_anchor")
# the FKVel attribute each row field fills
ATTR = {"pos": "body_pos", "com": "com", "omega": "omega", "v_com": "v_com",
        "alpha0": "alpha0", "a_com0": "a_com0", "dof_axis": "dof_axis",
        "dof_anchor": "dof_anchor", "body_rot": "body_rot",
        "inertia_w": "inertia_w"}


def packed_rows(sys_, e=6, seed=0):
    """Rows laid out as row_layout, packed from full_dyn_plain (float64)."""
    rng = np.random.RandomState(seed)
    qpos = sys_.default_qpos() + rng.uniform(-0.1, 0.1, (e, sys_.nq))
    for j in range(sys_.nj):
        if sys_.jnt_type[j] == 0:
            a = int(sys_.jnt_qposadr[j]) + 3
            qpos[:, a: a + 4] /= np.linalg.norm(qpos[:, a: a + 4], axis=-1,
                                                keepdims=True)
    args = [torch.tensor(x, dtype=torch.float64) for x in (
        qpos, rng.uniform(-1, 1, (e, sys_.nv)), rng.uniform(-1, 1, (e, sys_.nu)),
        rng.uniform(0.8, 1.2, e), rng.uniform(0.8, 1.2, e), np.ones((e, sys_.nu)))]
    fkv, minv, vpred = fk_kernel.full_dyn_plain(sys_, *args)
    values = {name: getattr(fkv, ATTR[name]) for name in ATTR}
    # FKVel has no quaternions: any quaternion of each body_rot will do,
    # since the rows' derived fields depend on the rotation alone
    values.update(quat=quat_from_rot(fkv.body_rot), minv=minv, v_pred=vpred)
    layout, width = fk_kernel.row_layout(sys_)
    rows = torch.zeros(e, width, dtype=torch.float64)
    for name, (off, n, comps) in layout.items():
        rows[:, off: off + n * comps] = values[name].reshape(e, -1)
    return rows, values


def quat_from_rot(R):
    """Unit quaternions (w, x, y, z) of rotation matrices, each from the
    largest of its four components (Shepperd's method)."""
    r = lambda i, j: R[..., i, j]  # noqa: E731
    cands = torch.stack([1 + r(0, 0) + r(1, 1) + r(2, 2),
                         1 + r(0, 0) - r(1, 1) - r(2, 2),
                         1 - r(0, 0) + r(1, 1) - r(2, 2),
                         1 - r(0, 0) - r(1, 1) + r(2, 2)], dim=-1)
    k = cands.argmax(-1, keepdim=True)
    s = 2 * torch.sqrt(cands.gather(-1, k))[..., 0]  # 4 × that component
    a, bq, c = r(2, 1) - r(1, 2), r(0, 2) - r(2, 0), r(1, 0) - r(0, 1)
    d, f, g = r(0, 1) + r(1, 0), r(0, 2) + r(2, 0), r(1, 2) + r(2, 1)
    branches = torch.stack([
        torch.stack([s / 4, a / s, bq / s, c / s], -1),
        torch.stack([a / s, s / 4, d / s, f / s], -1),
        torch.stack([bq / s, d / s, s / 4, g / s], -1),
        torch.stack([c / s, f / s, g / s, s / 4], -1)], dim=-2)
    return branches.gather(-2, k[..., None].expand(*k.shape[:-1], 1, 4))[..., 0, :]


@pytest.mark.parametrize("asset", ASSETS)
def test_row_layout_offsets_are_consistent(asset):
    sys_ = load_system(asset)
    nb, nv = sys_.nb, sys_.nv
    layout, width = fk_kernel.row_layout(sys_)
    names = list(layout)
    assert names == list(FK_NINE) + ["body_rot", "inertia_w", "minv", "v_pred"]
    off = 0
    for name in names:  # contiguous, in order, no overlap
        start, rows, comps = layout[name]
        assert start == off, name
        off += rows * comps
    assert off == width == 40 * nb + 6 * nv + nv * nv + nv
    # K3's row is the nine FK fields, a prefix that the new fields leave alone
    assert layout["body_rot"] == (fk_kernel.fk_width(sys_), nb, 9)
    assert layout["inertia_w"] == (fk_kernel.fk_width(sys_) + 9 * nb, nb, 9)


@pytest.mark.parametrize("asset", ASSETS)
def test_rows_give_back_their_rotations_and_inertias(asset):
    """K2-width rows: body_rot and inertia_w are views of the row itself;
    K3-width rows: they are derived from the quaternions."""
    sys_ = load_system(asset)
    rows, values = packed_rows(sys_)
    e = rows.shape[0]
    fkv = fk_kernel._fkvel_from_rows(sys_, rows)
    base, end = rows.data_ptr(), rows.data_ptr() + rows.numel() * 8
    for name in ATTR:
        got = getattr(fkv, ATTR[name])
        assert base <= got.data_ptr() < end, name  # a view of the row
        assert torch.equal(got, values[name]), name
    fields = fk_kernel.row_fields(sys_, rows)
    assert torch.equal(fields["minv"], values["minv"])
    assert torch.equal(fields["v_pred"], values["v_pred"])

    fk_rows = rows[:, : fk_kernel.fk_width(sys_)].contiguous()
    fkv3 = fk_kernel._fkvel_from_rows(sys_, fk_rows)
    assert set(fk_kernel.row_fields(sys_, fk_rows)) == set(FK_NINE)
    for name in ("body_rot", "inertia_w"):
        got = getattr(fkv3, name)
        assert not (fk_rows.data_ptr() <= got.data_ptr()
                    < fk_rows.data_ptr() + fk_rows.numel() * 8), name
        np.testing.assert_allclose(got.numpy(), values[name].numpy(),
                                   atol=1e-6, err_msg=name)
    assert fkv3.body_rot.shape == (e, sys_.nb, 3, 3)
