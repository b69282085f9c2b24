"""Shared set-up of the collect parity tests (test_torch_collect*.py,
test_torch_baselines_jax.py).

Both packages collect on a HalfCheetah whose reset is deterministic (fixed
hidden scales and start state), so that episodes ending inside the collect
restart identically on both sides and everything after the history / plan
wipe can be compared too. Episodes are 3 steps long and the envs start at
different ``t``, so dones fire at different steps; the ring (capacity 5)
wraps during the 6-step collect.

``SharedPhysics`` steps both packages' envs through the port's float32
physics (the JAX env's through a host callback), each call's inputs held
to the JAX env's: for tests of what lies above the physics, which is held
by tests/test_torch_physics.py and tests/test_torch_env.py.
"""
import copy

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
from cadm_tpu.models.grbal import GrBAL as JaxGrBAL
from cadm_tpu.models.grbal import GrBALConfig as JaxGrBALConfig
from cadm_tpu.planners.grbal_mpc import GrBALPlanner as JaxGrBALPlanner
from cadm_tpu.planners.mpc import MPCPlanner as JaxPlanner
from cadm_tpu.planners.mpc import PlannerConfig as JaxPlannerConfig
from cadm_tpu.train.buffer import ReplayBuffer as JaxBuffer
from cadm_tpu.train.mb_trainer import MBTrainer as JaxTrainer
from cadm_tpu.train.mb_trainer import TrainerConfig as JaxTrainerConfig
from cadm_tpu_torch.core.types import EnvState, batched_history
from cadm_tpu_torch.envs.half_cheetah import HalfCheetahEnv
from cadm_tpu_torch.envs.rigid_base import MassDampingParams, RigidPhys
from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig, DynamicsState
from cadm_tpu_torch.models.grbal import GrBAL, GrBALConfig
from cadm_tpu_torch.planners.grbal_mpc import GrBALPlanner
from cadm_tpu_torch.planners.mpc import MPCPlanner, PlannerConfig
from cadm_tpu_torch.train.mb_trainer import MBTrainer, TrainerConfig
from cadm_tpu_torch.utils.convert import params_from_jax

# the env tolerance of tests/test_torch_env.py (float32 physics through a
# control step), for everything derived from observations
OBS_ATOL = 1e-4
E, STEPS, CAPACITY, HORIZON, T0 = 4, 6, 5, 3, (0, 1, 2, 0)
C, H, ITERS, ELITES = 8, 3, 2, 2
MODEL = dict(obs_dim=17, act_dim=6, hidden=(16, 16), context="encoder",
             history_k=3)
PLAN = dict(kind="cem", horizon=H, n_candidates=C, cem_iters=ITERS,
            cem_elites=ELITES, warm_start=True)
_rng = np.random.RandomState(0)
RESET_QPOS = (JaxCheetah().sys.default_qpos()
              + _rng.uniform(-0.05, 0.05, 9)).astype(np.float32)
RESET_QVEL = (0.1 * _rng.randn(9)).astype(np.float32)


class DetJaxCheetah(JaxCheetah):
    horizon = HORIZON

    def sample_params(self, rng, mode):
        return JaxParams(jnp.float32(1.1), jnp.float32(0.9))

    def init_phys(self, rng, params):
        return JaxPhys(jnp.asarray(RESET_QPOS), jnp.asarray(RESET_QVEL))


class DetCheetah(HalfCheetahEnv):
    horizon = HORIZON

    def sample_params(self, gen, mode, n):
        return MassDampingParams(torch.full((n,), 1.1), torch.full((n,), 0.9))

    def init_phys(self, gen, params):
        n = params.mass_scale.shape[0]
        return RigidPhys(torch.from_numpy(RESET_QPOS).repeat(n, 1),
                         torch.from_numpy(RESET_QVEL).repeat(n, 1))


def host_tensor(x):
    return torch.from_numpy(np.array(x))


class SharedPhysics:
    """The port's ``step_phys`` for the JAX env, each call's inputs and
    result kept in order for the port's env to be held to and replay."""

    def __init__(self):
        self.port = HalfCheetahEnv(device="cpu")
        self.calls = []
        self.replayed = 0
        self.worst = {"qpos": 0.0, "qvel": 0.0, "act": 0.0}
        self.steps = {}  # the port's step of each input seen, by its bytes

    def restart(self) -> "SharedPhysics":
        """A copy holding the record so far; this one starts a new one
        (the JAX programs that call it, and the steps taken, are kept)."""
        done = copy.copy(self)
        self.calls, self.replayed = [], 0
        self.worst = dict.fromkeys(self.worst, 0.0)
        return done

    def jax_step_phys(self, params, phys, action):
        """The JAX env's ``step_phys``, under its vmap: one host call of
        the batch."""
        def host(ms, ds, qpos, qvel, act):
            inputs = [np.array(x) for x in (ms, ds, qpos, qvel, act)]
            key = b"".join(x.tobytes() for x in inputs)
            if key not in self.steps:   # a restarted run repeats some
                out = self.port.step_phys(
                    MassDampingParams(host_tensor(ms), host_tensor(ds)),
                    RigidPhys(host_tensor(qpos), host_tensor(qvel)),
                    host_tensor(act))
                self.steps[key] = (out.qpos.numpy(), out.qvel.numpy())
            result = self.steps[key]
            self.calls.append((inputs, result))
            return result

        shapes = (jax.ShapeDtypeStruct(phys.qpos.shape, jnp.float32),
                  jax.ShapeDtypeStruct(phys.qvel.shape, jnp.float32))
        qpos, qvel = jax.pure_callback(
            host, shapes, params.mass_scale, params.damping_scale, phys.qpos,
            phys.qvel, action, vmap_method="broadcast_all")
        return JaxPhys(qpos=qpos, qvel=qvel)

    def port_step_phys(self, params, phys, action):
        """The port env's ``step_phys``: the next recorded call, its inputs
        held to the port's."""
        (ms, ds, qpos, qvel, act), (q, v) = self.calls[self.replayed]
        self.replayed += 1
        np.testing.assert_array_equal(params.mass_scale.numpy(), ms)
        np.testing.assert_array_equal(params.damping_scale.numpy(), ds)
        for name, ours, ref in (("qpos", phys.qpos, qpos),
                                ("qvel", phys.qvel, qvel),
                                ("act", action, act)):
            self.worst[name] = max(self.worst[name],
                                   float(np.abs(ours.numpy() - ref).max()))
        return RigidPhys(host_tensor(q), host_tensor(v))


def jax_noise(key):
    """The ε of one planner call: (ITERS, E, C, H, 6), from the collect's
    key of that step (``mb_trainer.py:232`` → ``mpc.py:plan`` →
    ``_plan_single``)."""
    eps = [[jax.random.truncated_normal(jax.random.split(k)[0], -2.0, 2.0,
                                        (C, H, 6))
            for k in jax.random.split(k_env, ITERS)]
           for k_env in jax.random.split(key, E)]
    return torch.tensor(np.swapaxes(np.asarray(eps), 0, 1))


def setup(model=MODEL, grbal=False, physics=None,
          envs=(DetJaxCheetah, DetCheetah)):
    """(JAX trainer, JAX collect args, port trainer, port collect args) of
    the model config ``model``: a ``Dynamics`` one, or with ``grbal`` a
    ``GrBAL`` one, planned by each package's ``GrBALPlanner``; ``E``
    collect and eval envs each. ``physics``: a ``SharedPhysics`` both envs
    step through, else each package steps its own. ``envs``: the (JAX,
    port) env classes."""
    jax_env, port_env = envs
    tcfg = dict(n_envs=E, eval_envs=E, steps_per_itr=STEPS,
                buffer_capacity=CAPACITY)
    if physics is None:
        jenv = jax_env()
    else:
        class SharedJaxCheetah(jax_env):
            def step_phys(self, params, phys, action):
                return physics.jax_step_phys(params, phys, action)

        jenv = SharedJaxCheetah()
    jm = (JaxGrBAL(JaxGrBALConfig(**model)) if grbal
          else JaxDynamics(JaxConfig(**model)))
    jplanner = (JaxGrBALPlanner if grbal else JaxPlanner)(
        JaxPlannerConfig(**PLAN), jm, jenv.reward, 6,
        bad_transition_fn=jenv.bad_transition, obs_limit=jenv.bad_obs_limit)
    jtr = JaxTrainer(jenv, jm, jplanner, JaxTrainerConfig(**tcfg))
    env = port_env(device="cpu")
    if physics is not None:
        env.step_phys = physics.port_step_phys
    model = (GrBAL(GrBALConfig(**model), "cpu") if grbal
             else Dynamics(DynamicsConfig(**model), "cpu"))
    planner = (GrBALPlanner if grbal else MPCPlanner)(
        PlannerConfig(**PLAN), model, env.reward, 6,
        bad_transition_fn=env.bad_transition, obs_limit=env.bad_obs_limit)
    tr = MBTrainer(env, model, planner, TrainerConfig(**tcfg))

    rng = np.random.RandomState(1)
    qpos = (jenv.sys.default_qpos()
            + rng.uniform(-0.1, 0.1, (E, 9))).astype(np.float32)
    qvel = (0.1 * rng.randn(E, 9)).astype(np.float32)
    ms = np.array([0.75, 1.0, 1.25, 0.85], np.float32)
    ds = np.array([1.15, 0.75, 1.0, 1.25], np.float32)
    t = np.asarray(T0, np.int32)
    jphys = JaxPhys(jnp.asarray(qpos), jnp.asarray(qvel))
    jpar = JaxParams(jnp.asarray(ms), jnp.asarray(ds))
    jstates = JaxEnvState(
        phys=jphys, obs=jax.vmap(jenv.observe)(jpar, jphys), params=jpar,
        t=jnp.asarray(t), rng=jax.random.split(jax.random.key(2), E),
        done=jnp.zeros(E, bool))
    jdyn = jax.jit(jm.init_state)(jax.random.key(3))  # one compile
    jdyn = jdyn.replace(norm=JaxNorm(*(
        jnp.asarray(rng.uniform(lo, hi, n).astype(np.float32))
        for lo, hi, n in ((-1, 1, 17), (0.5, 2, 17), (-1, 1, 6), (0.5, 2, 6),
                          (-0.2, 0.2, 17), (0.1, 1, 17)))))
    jargs = (jstates, jax_batched_history(jm.cfg, E),
             JaxBuffer.create(E, CAPACITY, 17, 6), jdyn)

    phys = RigidPhys(torch.from_numpy(qpos), torch.from_numpy(qvel))
    par = MassDampingParams(torch.from_numpy(ms), torch.from_numpy(ds))
    states = EnvState(phys=phys, obs=env.observe(par, phys), params=par,
                      t=torch.from_numpy(t), done=torch.zeros(E, dtype=torch.bool))
    params, norm = params_from_jax(jax.tree.map(np.asarray, jdyn.params),
                                   jax.tree.map(np.asarray, jdyn.norm), "cpu")
    _, _, buffer, _ = tr.init(torch.Generator().manual_seed(0))
    args = (states, batched_history(model.cfg, E, "cpu"), buffer,
            DynamicsState(params, norm))
    return jtr, jargs, tr, args


def assert_collect_matches(jout, out):
    """Env states, histories, ring and metrics after both collects."""
    (jstates, jh, jbuf, jmet), (states, hists, buf, met) = jout, out
    close = lambda a, b, name: np.testing.assert_allclose(  # noqa: E731
        a.numpy(), np.asarray(b), atol=OBS_ATOL, err_msg=name)
    exact = lambda a, b, name: np.testing.assert_array_equal(  # noqa: E731
        a.numpy(), np.asarray(b), err_msg=name)
    assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))
    for name in ("obs", "act", "next_obs"):
        close(getattr(buf, name), getattr(jbuf, name), f"buffer.{name}")
    for name in ("done", "ep_step", "bad"):
        exact(getattr(buf, name), getattr(jbuf, name), f"buffer.{name}")
    # every env ended at least one episode: its history was wiped
    assert buf.done.any(dim=1).all()
    for name in ("obs", "dobs", "act", "rnn_h"):  # rnn_h: ReBAL's GRU state
        close(getattr(hists, name), getattr(jh, name), f"history.{name}")
    exact(hists.valid, jh.valid, "history.valid")
    close(states.obs, jstates.obs, "env obs")
    exact(states.t, jstates.t, "env t")
    assert sorted(met) == sorted(jmet)
    assert float(met["collect/episodes"]) == float(jmet["collect/episodes"])
    for key in met:
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   atol=OBS_ATOL, rtol=1e-5, err_msg=key)
