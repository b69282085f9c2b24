"""The premise of K1's active-set compaction, on the plain version.

The CUDA kernel (``cadm_tpu_torch/csrc/pgs.cu``) sweeps only the active
contacts (μ > 0) of each env. That is the same function because an inactive
contact's updates write λ = 0 and, once its λ is 0, its columns add nothing
to any other row's dot. Where an inactive contact starts with a nonzero λ0,
the kernel runs the first sweep over every contact, which zeroes it, and
the rest over the active set. Both claims are checked here with
``pgs_solve_plain`` alone: the full solve against the active sub-problem
solved on its own and scattered back with zeros.

The problems are built in float64 so that the comparison is of the two
algorithms, not of float32 summation orders over rows of different length;
the tolerance is 1e-6.
"""
import numpy as np
import pytest
import torch

from cadm_tpu_torch.ops.pgs import pgs_solve_plain

ATOL = 1e-6


def problem(nc, active, seed, e=5):
    """Seeded SPD systems like test_torch_kernels_plain.pgs_problem, with
    no, some or all contacts active; λ0 zero on the inactive contacts."""
    rng = np.random.RandomState(seed)
    G = rng.randn(e, 3 * nc, 3 * nc)
    A = G @ np.transpose(G, (0, 2, 1)) / (3 * nc) + 0.5 * np.eye(3 * nc)
    b = rng.randn(e, 3 * nc)
    v_star = np.abs(rng.randn(e, nc))
    if active == "none":
        mu = np.zeros((e, nc))
    elif active == "all":
        mu = rng.choice([0.5, 1.0], size=(e, nc))
    else:
        mu = rng.choice([0.0, 0.5, 1.0], size=(e, nc))
        mu[0] = 0.0  # one env with no active contact
        mu[1] = 0.8  # one with all active
    lam0 = np.abs(rng.randn(e, 3 * nc)) * np.repeat(mu > 0, 3, axis=1)
    return [torch.from_numpy(x) for x in (A, b, v_star, mu, lam0)]


def active_rows(mu_env):
    c = torch.nonzero(mu_env > 0)[:, 0]
    return c, (3 * c[:, None] + torch.arange(3)).reshape(-1)


def solve_active(A, b, v_star, mu, lam0, iters):
    """Each env's active sub-problem solved alone, scattered back with
    zeros on the inactive contacts."""
    out = torch.zeros_like(lam0)
    for i in range(A.shape[0]):
        c, r = active_rows(mu[i])
        if len(c) == 0:
            continue
        out[i, r] = pgs_solve_plain(
            A[i][r][:, r][None], b[i, r][None], v_star[i, c][None],
            mu[i, c][None], lam0[i, r][None], iters)[0]
    return out


@pytest.mark.parametrize("active", ["none", "some", "all"])
@pytest.mark.parametrize("nc", [4, 16, 29])
@pytest.mark.parametrize("lam0_inactive", ["zero", "nonzero"])
def test_full_solve_equals_active_set_solve(nc, active, lam0_inactive):
    A, b, v_star, mu, lam0 = problem(nc, active, seed=nc)
    iters = 6
    if lam0_inactive == "zero":
        # what contact_solve hands the kernel: the active set alone suffices
        expect = solve_active(A, b, v_star, mu, lam0, iters)
    else:
        # a nonzero λ0 on inactive contacts: one full sweep, then active only
        inactive = torch.repeat_interleave(mu <= 0, 3, dim=1)
        lam0 = lam0 + inactive * torch.rand(lam0.shape, dtype=lam0.dtype,
                                            generator=torch.Generator()
                                            .manual_seed(nc))
        first = pgs_solve_plain(A, b, v_star, mu, lam0, 1)
        assert torch.all(first[inactive] == 0)  # the sweep zeroes them
        expect = solve_active(A, b, v_star, mu, first, iters - 1)
    full = pgs_solve_plain(A, b, v_star, mu, lam0, iters)
    np.testing.assert_allclose(full.numpy(), expect.numpy(), atol=ATOL)
