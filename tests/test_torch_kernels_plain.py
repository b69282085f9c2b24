"""The plain versions of the port's three kernels against the JAX package.

K1 (``cadm_tpu_torch.ops.pgs``) is held against the Pallas PGS kernel run in
interpret mode; K2 (``cadm_tpu_torch.ops.fk_kernel.full_dyn``) against the
JAX composed smooth stage, which tests/test_fused_parity.py ties to the
Pallas kernel; K3 (``fk_kernel.fk_vel``) in tests/test_torch_fk_vel.py. The CUDA kernels
themselves are compared with these plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.envs.rigid_base import load_system as jax_load_system
from cadm_tpu.ops.fk_kernel import full_dyn_pallas
from cadm_tpu.ops.linalg import spd_inverse as jax_spd_inverse
from cadm_tpu.ops.pgs import pgs_solve as jax_pgs_solve
from cadm_tpu.physics.rigid import dynamics as jdyn
from cadm_tpu.physics.rigid.kinematics import forward_velocities
from cadm_tpu_torch.envs.rigid_base import load_system
from cadm_tpu_torch.ops import fk_kernel, pgs
from cadm_tpu_torch.ops.linalg import spd_inverse

# Tolerances: λ 1e-4 is the reference's own for its PGS kernel
# (test_fused_parity.py:130); Minv 5e-5 and v_pred 5e-4 are its fused-kernel
# tolerances (test_fused_parity.py:81-88); FK fields are a short float32
# chain of quaternion products, 1e-5 absolute.
LAM_ATOL, MINV_ATOL, VPRED_ATOL, FK_ATOL = 1e-4, 5e-5, 5e-4, 1e-5
FK_FIELDS = ("body_pos", "body_rot", "com", "inertia_w", "dof_axis",
             "dof_anchor", "omega", "v_com", "alpha0", "a_com0")


def pgs_problem(nc, seed=1, e=8):
    """Random SPD Delassus systems with a mix of inactive contacts."""
    rng = np.random.RandomState(seed)
    G = rng.randn(e, 3 * nc, 3 * nc)
    A = G @ np.transpose(G, (0, 2, 1)) / (3 * nc) + 0.5 * np.eye(3 * nc)
    b = rng.randn(e, 3 * nc)
    v_star = np.abs(rng.randn(e, nc))
    active_mu = rng.choice([0.0, 0.5, 1.0], size=(e, nc))
    lam0 = np.abs(rng.randn(e, 3 * nc)) * np.repeat(active_mu > 0, 3, axis=1)
    return [x.astype(np.float32) for x in (A, b, v_star, active_mu, lam0)]


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("nc", [4, 16])  # hopper-like, cheetah
def test_pgs_plain_matches_pallas_interpret(nc, warm):
    A, b, v_star, active_mu, lam0 = pgs_problem(nc)
    iters = 6 if warm else 15
    lam0 = lam0 if warm else np.zeros_like(b)
    ref = jax_pgs_solve(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(v_star),
        jnp.asarray(active_mu), jnp.asarray(lam0), nc=nc, iters=iters,
        interpret=True, block=8,
    )
    before = pgs.launches
    lam = pgs.pgs_solve(*map(torch.from_numpy, (A, b, v_star, active_mu, lam0)),
                        iters=iters)
    assert pgs.launches == before  # a CPU tensor never launches the kernel
    np.testing.assert_allclose(lam.numpy(), np.asarray(ref), atol=LAM_ATOL)
    inactive = np.repeat(active_mu == 0.0, 3, axis=1)
    assert np.all(lam.numpy()[inactive] == 0.0)


def test_wrappers_reject_other_devices():
    A, b, v_star, active_mu, _ = pgs_problem(4, e=2)
    meta = [torch.from_numpy(x).to("meta") for x in (A, b, v_star, active_mu)]
    with pytest.raises(ValueError, match="unsupported device"):
        pgs.pgs_solve(*meta, iters=1)
    sys_ = load_system("hopper")
    args = [torch.zeros(2, n, device="meta")
            for n in (sys_.nq, sys_.nv, sys_.nu)]
    args += [torch.ones(2, device="meta")] * 2 + [torch.ones(2, sys_.nu, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        fk_kernel.full_dyn(sys_, *args)
    with pytest.raises(ValueError, match="unsupported device"):
        fk_kernel.fk_vel(sys_, *args[:2])


def smooth_state(sys_, seed=0, n=4):
    """test_fused_parity._state: near-default poses, one masked actuator."""
    rng = np.random.RandomState(seed)
    qpos = sys_.default_qpos() + rng.uniform(-0.1, 0.1, (n, sys_.nq))
    for j in range(sys_.nj):
        if sys_.jnt_type[j] == 0:
            a = int(sys_.jnt_qposadr[j]) + 3
            qpos[:, a: a + 4] /= np.linalg.norm(qpos[:, a: a + 4], axis=-1,
                                                keepdims=True)
    qvel = rng.uniform(-1, 1, (n, sys_.nv))
    ctrl = rng.uniform(-1, 1, (n, sys_.nu))
    ms = rng.uniform(0.8, 1.2, (n,))
    ds = rng.uniform(0.8, 1.2, (n,))
    am = np.ones((n, sys_.nu))
    am[0, 0] = 0.0
    return [x.astype(np.float32) for x in (qpos, qvel, ctrl, ms, ds, am)]


def jax_smooth(sys_, qpos, qvel, ctrl, ms, ds, am):
    """The reference's composed smooth stage (dynamics._smooth_dispatch)."""
    fkv = forward_velocities(sys_, qpos, qvel)
    M = jdyn.mass_matrix(sys_, fkv, ms)
    c = jdyn.bias_from_fkvel(sys_, fkv, ms)
    B = jnp.asarray(sys_.dof_damping) * ds
    tau = (jdyn.actuation(sys_, ctrl, am)
           + jdyn.passive_forces(sys_, qpos, qvel, ds) - c - B * qvel)
    Minv = jax_spd_inverse(M + sys_.dt * jnp.diag(B))
    return fkv, Minv, qvel + sys_.dt * (Minv @ tau)


@pytest.mark.parametrize("asset", ["hopper", "half_cheetah"])
def test_full_dyn_plain_matches_jax_composed(asset):
    jsys = jax_load_system(asset + ".xml")
    args = smooth_state(jsys)
    fkv_ref, minv_ref, vpred_ref = jax.vmap(
        lambda *a: jax_smooth(jsys, *a))(*map(jnp.asarray, args))
    before = fk_kernel.launches
    fkv, minv, vpred = fk_kernel.full_dyn(load_system(asset),
                                          *map(torch.from_numpy, args))
    assert fk_kernel.launches == before
    np.testing.assert_allclose(minv.numpy(), np.asarray(minv_ref),
                               atol=MINV_ATOL)
    np.testing.assert_allclose(vpred.numpy(), np.asarray(vpred_ref),
                               atol=VPRED_ATOL)
    for name in FK_FIELDS:
        np.testing.assert_allclose(
            getattr(fkv, name).numpy(), np.asarray(getattr(fkv_ref, name)),
            atol=FK_ATOL, err_msg=name,
        )


def test_spd_inverse_clamps_like_the_reference():
    """A non-positive pivot is divided by sqrt(max(s, 1e-12)) as in the
    reference, where torch.linalg.cholesky would raise."""
    M = np.array([[[1.0, 0.0], [0.0, -1.0]]], np.float32)
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(torch.from_numpy(M))
    ref = np.asarray(jax_spd_inverse(jnp.asarray(M)))
    out = spd_inverse(torch.from_numpy(M)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-6)


@pytest.mark.slow
def test_full_dyn_plain_matches_pallas_interpret_cheetah():
    """The port's plain K2 against the Pallas kernel itself (~4 min)."""
    jsys = jax_load_system("half_cheetah.xml")
    args = smooth_state(jsys)
    d = full_dyn_pallas(jsys, *map(jnp.asarray, args), interpret=True, block=8)
    fkv, minv, vpred = fk_kernel.full_dyn(load_system("half_cheetah"),
                                          *map(torch.from_numpy, args))
    np.testing.assert_allclose(minv.numpy(), np.asarray(d["minv"]),
                               atol=MINV_ATOL)
    np.testing.assert_allclose(vpred.numpy(), np.asarray(d["v_pred"][..., 0]),
                               atol=VPRED_ATOL)
    for name, key in (("body_pos", "pos"), ("com", "com"), ("omega", "omega"),
                      ("v_com", "v_com"), ("alpha0", "alpha0"),
                      ("a_com0", "a_com0"), ("dof_axis", "dof_axis"),
                      ("dof_anchor", "dof_anchor")):
        np.testing.assert_allclose(getattr(fkv, name).numpy(),
                                   np.asarray(d[key]), atol=FK_ATOL,
                                   err_msg=name)
