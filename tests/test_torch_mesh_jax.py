"""The port's mesh (``cadm_tpu_torch/parallel``) against the JAX package's
(``cadm_tpu/parallel/mesh.py``), on the CPU:

- ``sharded_env_step`` on the conftest's 8-device (4, 2) mesh against the
  port's per-rank steps (each dp rank's block of hopper envs, drawing as a
  rank does through ``EnvRows``), concatenated;
- the port's member-sharded ``Dynamics.update`` on a (dp=2, model=2) gloo
  mesh (``parallel.mesh.spawn``) against the JAX ``model.update`` on a
  ``shard_dynamics_state``-placed state, three updates with the
  global-norm clip firing on one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cadm_tpu.envs import make as jax_make
from cadm_tpu.models.dynamics import Dynamics as JaxDynamics
from cadm_tpu.models.dynamics import DynamicsConfig as JaxConfig
from cadm_tpu.models.dynamics import NormStats as JaxNorm
from cadm_tpu.models.dynamics import SegmentBatch as JaxBatch
from cadm_tpu.parallel import mesh as jax_mesh
from cadm_tpu_torch.core.types import EnvState
from cadm_tpu_torch.envs import make
from cadm_tpu_torch.envs.rigid_base import MassDampingParams, RigidPhys
from cadm_tpu_torch.models.dynamics import (
    DynamicsConfig,
    DynamicsState,
    SegmentBatch,
)
from cadm_tpu_torch.core.rng import EnvRows
from cadm_tpu_torch.parallel.mesh import spawn
from cadm_tpu_torch.utils.convert import adam_state_from_jax, params_from_jax
from tests import torch_mesh_common as common

# float32 matmul chains and their gradients, summed in another order than
# XLA's: test_torch_fit.py's 1e-5; the env step: test_torch_env_families.py's
# obs and reward tolerance
ATOL, OBS_ATOL = 1e-5, 1e-4


def hopper_states(n):
    """JAX hopper reset states of ``n`` envs, and the port's copy."""
    jenv = jax_make("hopper")
    js = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(3), n))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    port = EnvState(phys=RigidPhys(t(js.phys.qpos), t(js.phys.qvel)),
                    obs=t(js.obs),
                    params=MassDampingParams(t(js.params.mass_scale),
                                             t(js.params.damping_scale)),
                    t=t(js.t), done=t(js.done))
    return jenv, js, port


def test_sharded_env_step_matches_jax_per_shard_steps():
    n, dp = 8, 4
    jenv, js, port = hopper_states(n)
    jmesh = jax_mesh.make_mesh(dp=dp, model=2)
    actions = np.random.RandomState(0).uniform(
        -1, 1, (n, jenv.act_dim)).astype(np.float32)
    step = jax_mesh.sharded_env_step(jenv, jmesh, n)
    assert step.is_sharded
    _, jobs, jrew, jdone = jax.jit(step)(js, jnp.asarray(actions))

    env = make("hopper", device="cpu")
    gen = torch.Generator().manual_seed(0)
    outs = []
    for d in range(dp):  # each dp rank steps its own block of 2 envs
        block = slice(d * n // dp, (d + 1) * n // dp)
        state = dataclasses.replace(
            port, phys=RigidPhys(port.phys.qpos[block], port.phys.qvel[block]),
            obs=port.obs[block], t=port.t[block], done=port.done[block],
            params=MassDampingParams(port.params.mass_scale[block],
                                     port.params.damping_scale[block]))
        outs.append(env.step(state, torch.from_numpy(actions[block]),
                             EnvRows(gen, d, dp))[1:])
    obs, rew, done = (torch.cat(x).numpy() for x in zip(*outs))
    assert not np.asarray(jdone).any() and not done.any()
    np.testing.assert_allclose(obs, np.asarray(jobs), atol=OBS_ATOL)
    np.testing.assert_allclose(rew, np.asarray(jrew), atol=OBS_ATOL)


OBS, ACT, K, M, B, N = 8, 3, 3, 4, 8, 2
MODEL = dict(obs_dim=OBS, act_dim=ACT, hidden=(16, 16), context="encoder",
             history_k=K, future_m=M, n_members=N, probabilistic=True)


def batch_np(seed, target_scale=1.0):
    """An (N, B, ...) segment batch with partly masked steps."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(N, B, *s).astype(np.float32)  # noqa: E731
    obs = f(M, OBS)
    return dict(
        hist_obs=f(K, OBS), hist_dobs=f(K, OBS),
        hist_act=rng.uniform(-1, 1, (N, B, K, ACT)).astype(np.float32),
        hist_valid=(rng.rand(N, B, K) > 0.3).astype(np.float32),
        obs=obs, act=rng.uniform(-1, 1, (N, B, M, ACT)).astype(np.float32),
        next_obs=obs + target_scale * 0.3 * f(M, OBS),
        valid=(rng.rand(N, B, M) > 0.2).astype(np.float32))


def test_sharded_update_matches_jax_on_a_sharded_state(tmp_path):
    """Three updates, the clip firing on the second (its global norm must
    count each member block once and each shared leaf once)."""
    jm = JaxDynamics(JaxConfig(**MODEL))
    rng = np.random.RandomState(1)
    norm = JaxNorm(*(jnp.asarray(rng.uniform(lo, hi, n).astype(np.float32))
                     for lo, hi, n in ((-1, 1, OBS), (0.5, 2, OBS),
                                       (-1, 1, ACT), (0.5, 2, ACT),
                                       (-0.2, 0.2, OBS), (0.1, 1, OBS))))
    jstate = dataclasses.replace(jm.init_state(jax.random.key(3)), norm=norm)
    batches = [batch_np(s, target_scale=40.0 if s == 1 else 1.0)
               for s in range(3)]
    params, pnorm = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                    jax.tree.map(np.asarray, jstate.norm),
                                    "cpu")
    opt = adam_state_from_jax(jax.tree.map(np.asarray,
                                           jstate.opt_state[1][0]), "cpu")
    torch.save({"cfg": DynamicsConfig(**MODEL),
                "state": DynamicsState(params, pnorm, opt, 0),
                "batches": [SegmentBatch(**{k: torch.from_numpy(v)
                                            for k, v in b.items()})
                            for b in batches]}, tmp_path / "in.pt")

    jstate = jax_mesh.shard_dynamics_state(
        jstate, jax_mesh.make_mesh(dp=4, model=2))
    jupdate = jax.jit(jm.update)
    for b in batches:
        jstate, _ = jupdate(jstate, JaxBatch(**{k: jnp.asarray(v)
                                                for k, v in b.items()}))
    ref = [np.asarray(x) for tree in (jstate.params,
                                      jstate.opt_state[1][0].mu,
                                      jstate.opt_state[1][0].nu)
           for x in jax.tree.leaves(tree)]
    for out in spawn(common.update, 2, 2, ["cpu"] * 4,
                     args=(str(tmp_path / "in.pt"),)):
        assert len(out) == len(ref)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), b, atol=ATOL)
