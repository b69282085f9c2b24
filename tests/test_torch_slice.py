"""The acting slice as a whole, port against JAX, at toy width.

HalfCheetah, CaDM with heads (32, 32), CEM with 16 candidates × horizon 5 ×
2 iterations, 4 envs. Both sides start from the same states, plan through
the same (JAX-initialized) weights with the same ε (the JAX planner's key
splits rebuilt here), step their own physics and push their own context
histories; actions and observations are compared after each of 3 control
steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cadm_tpu.core.types import EnvState as JaxEnvState
from cadm_tpu.core.types import batched_history as jax_batched_history
from cadm_tpu.envs.half_cheetah import HalfCheetahEnv as JaxCheetah
from cadm_tpu.envs.rigid_base import MassDampingParams as JaxParams
from cadm_tpu.envs.rigid_base import RigidPhys as JaxPhys
from cadm_tpu.models.dynamics import Dynamics as JaxDynamics
from cadm_tpu.models.dynamics import DynamicsConfig as JaxConfig
from cadm_tpu.models.dynamics import NormStats as JaxNorm
from cadm_tpu.planners.mpc import MPCPlanner as JaxPlanner
from cadm_tpu.planners.mpc import PlannerConfig as JaxPlannerConfig
from cadm_tpu_torch.cli.presets import PRESETS
from cadm_tpu_torch.core.types import EnvState, batched_history
from cadm_tpu_torch.envs.rigid_base import MassDampingParams, RigidPhys
from cadm_tpu_torch.models.dynamics import DynamicsState
from cadm_tpu_torch.utils.convert import params_from_jax

# Tolerance: each step adds float32 model rollouts (≤ 1e-6 apart, see
# test_torch_planner.py) and 5 physics substeps (~2e-6, test_torch_physics.py);
# the CEM elites are the same candidates on both sides, so three control steps
# stay well inside 1e-4 for actions and observations.
ATOL = 1e-4
E, C, H, ITERS, ELITES, STEPS = 4, 16, 5, 2, 4, 3
CFG = dataclasses.replace(
    PRESETS["halfcheetah_cadm_cem"], hidden=(32, 32), n_candidates=C,
    plan_horizon=H, cem_iters=ITERS, cem_elites=ELITES, n_envs=E, eval_envs=E,
)


def jax_noise(key):
    """The JAX planner's truncated-normal ε per env: (ITERS, E, C, H, 6)."""
    eps = [[jax.random.truncated_normal(jax.random.split(k)[0], -2.0, 2.0,
                                        (C, H, 6))
            for k in jax.random.split(k_env, ITERS)]
           for k_env in jax.random.split(key, E)]
    return torch.tensor(np.swapaxes(np.asarray(eps), 0, 1))


def test_slice_matches_jax_for_three_control_steps():
    # --- JAX side
    jenv = JaxCheetah()
    jm = JaxDynamics(JaxConfig(obs_dim=17, act_dim=6, hidden=CFG.hidden,
                               context="encoder"))
    jparams = jm.init_params(jax.random.key(5))
    jnorm = JaxNorm.identity(17, 6)
    jplanner = JaxPlanner(
        JaxPlannerConfig(kind="cem", horizon=H, n_candidates=C,
                         cem_iters=ITERS, cem_elites=ELITES),
        jm, jenv.reward, 6, bad_transition_fn=jenv.bad_transition,
        obs_limit=jenv.bad_obs_limit)
    plan = jax.jit(jax.vmap(lambda o, zz, k: jplanner._plan_single(
        jparams, jnorm, o, zz, jnp.zeros((H, 6)), k)))
    jstep = jax.jit(jax.vmap(jenv.step))

    rng = np.random.RandomState(0)
    qpos = (jenv.sys.default_qpos() + rng.uniform(-0.1, 0.1, (E, 9))).astype(np.float32)
    qvel = (0.1 * rng.randn(E, 9)).astype(np.float32)
    ms = np.array([0.75, 1.0, 1.25, 0.85], np.float32)
    ds = np.array([1.15, 0.75, 1.0, 1.25], np.float32)
    jphys = JaxPhys(jnp.asarray(qpos), jnp.asarray(qvel))
    jpar = JaxParams(jnp.asarray(ms), jnp.asarray(ds))
    jstate = JaxEnvState(
        phys=jphys, obs=jax.vmap(jenv.observe)(jpar, jphys), params=jpar,
        t=jnp.zeros(E, jnp.int32), rng=jax.random.split(jax.random.key(1), E),
        done=jnp.zeros(E, bool))
    jh = jax_batched_history(jm.cfg, E)

    # --- port, built from the preset at toy width
    env, model, planner, _ = CFG.build("cpu")
    params, norm = params_from_jax(jax.tree.map(np.asarray, jparams),
                                   jax.tree.map(np.asarray, jnorm))
    dyn = DynamicsState(params, norm)
    phys = RigidPhys(torch.from_numpy(qpos), torch.from_numpy(qvel))
    par = MassDampingParams(torch.from_numpy(ms), torch.from_numpy(ds))
    state = EnvState(phys=phys, obs=env.observe(par, phys), params=par,
                     t=torch.zeros(E, dtype=torch.int32),
                     done=torch.zeros(E, dtype=torch.bool))
    hists = batched_history(model.cfg, E)
    gen = torch.Generator().manual_seed(0)

    for t, key in enumerate(jax.random.split(jax.random.key(9), STEPS)):
        jz = jm.context_from_history(jparams, jnorm, jh)
        jact, _ = plan(jstate.obs, jz, jax.random.split(key, E))
        jprev = jstate.obs
        jstate, jobs, _, _ = jstep(jstate, jact)
        jh = jm.push_history(jparams, jnorm, jh, jprev, jobs - jprev, jact)

        z = model.context_from_history(dyn.params, dyn.norm, hists)
        act, _ = planner.plan(dyn, state.obs, z, gen, noise=jax_noise(key))
        prev = state.obs
        state, obs, _, done = env.step(state, act, gen)
        hists = model.push_history(dyn.params, dyn.norm, hists, prev,
                                   obs - prev, act)

        np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=ATOL,
                                   err_msg=f"z, step {t}")
        np.testing.assert_allclose(act.numpy(), np.asarray(jact), atol=ATOL,
                                   err_msg=f"actions, step {t}")
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=ATOL,
                                   err_msg=f"obs, step {t}")
        assert not done.any()
