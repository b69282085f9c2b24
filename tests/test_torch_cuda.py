"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (the decision is made inside the fixture, never at import). On a
machine with a card and nvcc run ``python -m pytest tests/test_torch_cuda.py``;
``chip_smoke.py`` runs the same checks at the main path's shapes.
"""
import numpy as np
import pytest
import torch

from cadm_tpu_torch.envs.rigid_base import ASSETS, load_system
from cadm_tpu_torch.ops import fk_kernel, pgs
from cadm_tpu_torch.physics.rigid import dynamics as rdyn

pytestmark = pytest.mark.cuda

# λ 1e-4 is the reference's PGS tolerance; K2 is held against its plain
# version run in float64 at the reference's fused-kernel tolerances (the
# kernel computes in double; see chip_smoke.py for why float32 cannot meet
# them on slim_humanoid)
LAM_ATOL, MINV_ATOL, VPRED_ATOL, FK_ATOL = 1e-4, 5e-5, 5e-4, 1e-5
FK_FIELDS = ("body_pos", "body_rot", "com", "inertia_w", "dof_axis",
             "dof_anchor", "omega", "v_com", "alpha0", "a_com0")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("nc", [16, 29])
@pytest.mark.parametrize("iters", [15, 6])
def test_pgs_kernel_matches_plain(dev, nc, iters):
    e, n = 301, 3 * nc  # a ragged env count (blocks hold up to 4 envs)
    g = torch.Generator(device=dev).manual_seed(nc + iters)
    G = torch.randn(e, n, n, generator=g, device=dev)
    A = G @ G.transpose(1, 2) / n + 0.5 * torch.eye(n, device=dev)
    b = torch.randn(e, n, generator=g, device=dev)
    vstar = torch.randn(e, nc, generator=g, device=dev).abs()
    actmu = torch.tensor([0.0, 0.5, 1.0], device=dev)[
        torch.randint(0, 3, (e, nc), generator=g, device=dev)]
    inactive = (actmu == 0).repeat_interleave(3, dim=1)
    lam0 = torch.randn(e, n, generator=g, device=dev).abs() * ~inactive
    before = pgs.launches
    lam = pgs.pgs_solve(A, b, vstar, actmu, lam0, iters=iters)
    assert pgs.launches == before + 1
    ref = pgs.pgs_solve_plain(A, b, vstar, actmu, lam0, iters)
    assert (lam - ref).abs().max().item() <= LAM_ATOL
    assert torch.all(lam[inactive] == 0)


@pytest.mark.parametrize("asset", ASSETS)
def test_full_dyn_kernel_matches_plain_float64(dev, asset):
    sys_ = load_system(asset)
    e = 257  # ragged against the 128-thread blocks
    rng = np.random.RandomState(0)
    qpos = sys_.default_qpos() + rng.uniform(-0.1, 0.1, (e, sys_.nq))
    for j in range(sys_.nj):
        if sys_.jnt_type[j] == 0:
            a = int(sys_.jnt_qposadr[j]) + 3
            qpos[:, a: a + 4] /= np.linalg.norm(qpos[:, a: a + 4], axis=-1,
                                                keepdims=True)
    am = np.ones((e, sys_.nu))
    am[::7, 0] = 0.0
    args = [torch.tensor(x, dtype=torch.float32, device=dev) for x in (
        qpos, rng.uniform(-1, 1, (e, sys_.nv)), rng.uniform(-1, 1, (e, sys_.nu)),
        rng.uniform(0.8, 1.2, e), rng.uniform(0.8, 1.2, e), am)]
    fkv, minv, vpred = fk_kernel.full_dyn(sys_, *args)
    fkv_r, minv_r, vpred_r = fk_kernel.full_dyn_plain(
        sys_, *(a.double() for a in args))
    assert (minv.double() - minv_r).abs().max().item() <= MINV_ATOL
    assert (vpred.double() - vpred_r).abs().max().item() <= VPRED_ATOL
    for name in FK_FIELDS:
        err = (getattr(fkv, name).double() - getattr(fkv_r, name)).abs().max()
        assert err.item() <= FK_ATOL, name


def test_step_n_on_the_card_matches_the_cpu(dev):
    """Both kernels on the physics path, against the plain versions on CPU."""
    sys_ = load_system("half_cheetah")
    rng = np.random.RandomState(1)
    qpos = sys_.default_qpos() + rng.uniform(-0.1, 0.1, (64, sys_.nq))
    qpos[:, 1] -= np.linspace(0.0, 0.3, 64)  # some envs in ground contact
    host = [torch.tensor(x, dtype=torch.float32) for x in (
        qpos, rng.uniform(-1, 1, (64, sys_.nv)), rng.uniform(-1, 1, (64, sys_.nu)))]
    params = rdyn.RigidParams.default(sys_, 64)
    before = (pgs.launches, fk_kernel.launches)
    q_d, v_d = rdyn.step_n(sys_, rdyn.RigidParams.default(sys_, 64, dev),
                           *(x.to(dev) for x in host), 5)
    assert (pgs.launches - before[0], fk_kernel.launches - before[1]) == (5, 5)
    q_h, v_h = rdyn.step_n(sys_, params, *host, 5)
    np.testing.assert_allclose(q_d.cpu().numpy(), q_h.numpy(), atol=1e-5)
    np.testing.assert_allclose(v_d.cpu().numpy(), v_h.numpy(), atol=1e-4)
