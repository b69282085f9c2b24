"""The port's PPO + CaDM trainer against the JAX package's on half_cheetah,
over two whole iterations of ``train`` (4 envs, T = 16, 24-step episodes).

Every JAX draw is rebuilt from its keys and injected, as
tests/test_torch_ppo.py does on pendulum: the collect's ε, the PPO
permutations, the fit's segment indices and the eval's start states. The
new part is the auto-reset inside a collect. The JAX env resets a done env
from the key its state carries (``cadm_tpu/envs/base.py``: ``fresh =
reset(state.rng, mode)``, the next key the third of ``split(rng, 3)``), so
each env's fresh states form a chain fixed by its first key, whenever its
dones fire. ``JaxResets`` walks that chain, and a test-side override of the
port env's ``reset`` hands the port those states, in order.

The envs start at t = 0, 5, 10, 15 of their episodes: env 3 and env 2 end
inside the first collect, env 1 and env 0 in the second, and each env has
an episode that spans the boundary between the two collects (the return
accumulator restarts, the history is wiped and GAE treats the auto-reset as
terminal on both sides of it).

One physics for both. Each package's own float32 step is held to the
other's at fixed inputs by tests/test_torch_physics.py and
tests/test_torch_env.py (1e-4). Over a closed loop that is not enough: a
contact pushed out by the solve lands at a separation within rounding of
zero, and where one package's separation is -1.1e-8 and the other's is not
below 0 (the first eval of this file, step 7), one solve applies a contact
impulse and the other none, and the next obs part by 0.98. So the JAX env's
``step_phys`` runs the port's (its plain K1 and K2, through a host
callback), every call recorded; the port's env checks at each call that its
inputs are the JAX env's (obs tolerance) and takes the recorded result.
Everything else on both sides is each package's own: the trainer, the env's
clip, observe, reward, done and auto-reset, the model, ring and fit.

After each collect the env states, histories, ring, trajectory and
bootstrap value are held to the JAX package's; after the two iterations
both metrics rows key for key, and the final policy, log_std, value and
model params with their Adam states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.envs.half_cheetah import HalfCheetahEnv as JaxCheetah
from cadm_tpu.models.dynamics import Dynamics as JaxDynamics
from cadm_tpu.models.dynamics import DynamicsConfig as JaxConfig
from cadm_tpu.models.dynamics import NormStats as JaxNorm
from cadm_tpu.train.buffer import ReplayBuffer as JaxBuffer
from cadm_tpu.train.ppo import PPOConfig as JaxPPOConfig
from cadm_tpu.train.ppo import PPOTrainer as JaxPPOTrainer
from cadm_tpu_torch.core.types import tree_leaves
from cadm_tpu_torch.envs.half_cheetah import HalfCheetahEnv
from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig
from cadm_tpu_torch.train.buffer import ReplayBuffer
from cadm_tpu_torch.train.ppo import PPOConfig, PPOTrainer
from cadm_tpu_torch.utils.convert import (
    buffer_from_jax,
    dynamics_state_from_jax,
    env_state_from_jax,
    history_from_jax,
    ppo_state_from_jax,
)
from tests.torch_collect_common import SharedPhysics

# tests/test_torch_ppo.py's tolerances: params after Adam steps 1e-5,
# losses 1e-5 relative; everything derived from obs (the trajectory's
# obs_z, the ring, the histories, the returns per step) at the cheetah
# step's 1e-4 (tests/test_torch_env.py), and an action fed to the physics
# at 1e-5 (a policy of obs within 1e-4 whose weights are O(1/√16))
PARAM_ATOL, LOSS_RTOL, OBS_ATOL, ACT_ATOL = 1e-5, 1e-5, 1e-4, 1e-5
E, T, HORIZON, EVAL_ENVS, N_ITR = 4, 16, 24, 2, 2
T0 = (0, 5, 10, 15)
MODEL = dict(obs_dim=17, act_dim=6, hidden=(16, 16), context="encoder",
             z_dim=4, history_k=4, future_m=3, encoder_hidden=(16,))
PPO = dict(n_envs=E, rollout_len=T, n_itr=N_ITR, policy_hidden=(16, 16),
           ppo_epochs=2, minibatches=2, model_updates_per_itr=5,
           model_batch=8, eval_envs=EVAL_ENVS, eval_modes=(0,))
# the ring: room for both collects, and one that the second collect wraps
# (24 < 2·T: the second fit draws from a ring whose oldest column is 8)
CAPACITIES = (64, 24)


def t(x):
    return torch.from_numpy(np.array(x))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_cheetah(physics):
    class JaxCheetah24(JaxCheetah):
        horizon = HORIZON

        def step_phys(self, params, phys, action):
            return physics.jax_step_phys(params, phys, action)

    return JaxCheetah24()


def port_states(js):
    return env_state_from_jax(js, "cpu")


class JaxResets:
    """The fresh states the JAX env auto-resets to, per env: ``reset(k)``
    of the env's current key, which moves on to ``split(k, 3)[2]`` at each
    of its resets. ``shared``: another chain's, whose programs this one
    takes over."""

    def __init__(self, jenv, keys, shared=None):
        if shared is None:
            self._reset = jax.jit(jax.vmap(lambda k: jenv.reset(k, 0)))
            self._next = jax.jit(jax.vmap(
                lambda k: jax.random.split(k, 3)[2]))
        else:
            self._reset, self._next = shared._reset, shared._next
        self.keys = keys
        self.fresh = port_states(self._reset(keys))
        self.count = 0

    def advance(self, done):
        """Move the keys of the envs that were ``done`` on."""
        if not done.any():
            return
        self.count += int(done.sum())
        data = jnp.where(jnp.asarray(done.numpy())[:, None],
                         jax.random.key_data(self._next(self.keys)),
                         jax.random.key_data(self.keys))
        self.keys = jax.random.wrap_key_data(data)
        self.fresh = port_states(self._reset(self.keys))


def jax_noise(rng):
    """The collect's ε: its scan key of step t, split, first half."""
    return torch.stack([t(jax.random.normal(jax.random.split(k)[0], (E, 6)))
                        for k in jax.random.split(rng, T)])


def jax_perms(jtr, rng):
    return torch.stack([t(jax.random.permutation(k, T * E)) for k in
                        jax.random.split(rng, jtr.cfg.ppo_epochs)])


def jax_fit_keys(tr, rng):
    """The keys of one JAX ``_fit_model``'s segment draws, in order: one
    train batch per update, then a valid batch."""
    r_train, r_valid = jax.random.split(rng)
    return [("train", k) for k in jax.random.split(
        r_train, tr.cfg.model_updates_per_itr)] + [("valid", r_valid)]


def inject_fit_draws(tr, keys):
    """``tr._draw`` returns the segment indices the JAX fit draws from
    ``keys`` (tests/test_torch_fit.py rebuilds them so)."""
    def injected(buffer, gen, split):
        want, k = keys.pop(0)
        assert split == want
        r_env, r_t = jax.random.split(k)
        shape = (tr.model.cfg.n_members, tr.cfg.model_batch)
        high = (buffer.n_train_anchors() if split == "train"
                else buffer.n_valid_anchors())
        env_idx = jax.random.randint(r_env, shape, 0, buffer.n_envs)
        u = jax.random.randint(r_t, shape, 0, max(high, 1))
        return t(env_idx), buffer.anchor_columns(t(u), split)

    tr._draw = injected


def jax_eval_states(jtr, rng, mode):
    r_reset, _ = jax.random.split(rng)
    return jax.vmap(lambda k: jtr.env.reset(k, mode))(
        jax.random.split(r_reset, jtr.cfg.eval_envs))


def random_norm(seed=0):
    """A norm of random statistics, so that z is not a function of zeros
    in the first collect."""
    rng = np.random.RandomState(seed)
    return JaxNorm(*(jnp.asarray(rng.uniform(lo, hi, n).astype(np.float32))
                     for lo, hi, n in ((-1, 1, 17), (0.5, 2, 17), (-1, 1, 6),
                                       (0.5, 2, 6), (-0.2, 0.2, 17),
                                       (0.1, 1, 17))))


def snapshot(out):
    """A collect's (env states, histories, ring, trajectory, bootstrap
    value), the port's ring copied (the next collect appends in place)."""
    states, hists, buf, traj, last = out
    if isinstance(buf, ReplayBuffer):
        buf = ReplayBuffer(*(x.clone() for x in (
            buf.obs, buf.act, buf.next_obs, buf.done, buf.ep_step, buf.bad)),
            buf.ptr, buf.size)
    return states, hists, buf, dict(traj), last


def train_both(capacity, shared=None, eval_modes=PPO["eval_modes"]):
    """Both trainers' two iterations on a ring of ``capacity`` columns →
    (JAX, port), each (ppo state, model state, metrics rows, per-collect
    snapshots), and the shared physics and the reset chain. ``shared``: the
    JAX trainer, physics and reset chain of a run at another capacity:
    this run calls that physics (restarted) and takes over the init (its
    ring made anew), update and reset programs. ``eval_modes``: () runs no
    evals."""
    physics = SharedPhysics() if shared is None else shared[1]
    jenv = jax_cheetah(physics)
    ppo = dict(PPO, buffer_capacity=capacity, eval_modes=eval_modes)
    jtr = JaxPPOTrainer(jenv, JaxDynamics(JaxConfig(**MODEL)),
                        JaxPPOConfig(**ppo))
    if shared is not None:
        jtr._ppo_update = shared[0]._ppo_update
    init = jax.jit(jtr.init)   # one compile, not one per eager op

    @jax.jit
    def staggered_init(rng):
        states, hists, buf, ps, dyn = init(rng)
        # log_std is weak-typed at init, so the second iteration would
        # compile the collect and the update again: the same values, typed
        ps = jax.tree.map(lambda x: x.astype(x.dtype), ps)
        return (states.replace(t=jnp.asarray(T0, jnp.int32)), hists, buf, ps,
                dyn.replace(norm=random_norm()))

    if shared is not None:
        # the same init but for the ring, which is its only leaf that
        # depends on the capacity
        def staggered_init(rng, init=shared[0].init):
            states, hists, _, ps, dyn = init(rng)
            return (states, hists, JaxBuffer.create(
                E, capacity, MODEL["obs_dim"], MODEL["act_dim"]), ps, dyn)

    jtr.init = staggered_init
    jcollects, collect = [], jtr._collect

    def recorded(*a):
        out = collect(*a)
        jcollects.append(snapshot(out))
        return out

    jtr._collect = recorded
    rng = jax.random.key(11)
    jps, jdyn, jrows = jtr.train(rng)

    # the port, every draw rebuilt from the keys of the JAX train loop
    r_init, r = jax.random.split(rng)
    keys = []
    for _ in range(N_ITR):
        r, *k = jax.random.split(r, 5)
        keys.append(k)
    jinit = staggered_init(r_init)
    env = HalfCheetahEnv(device="cpu", horizon=HORIZON)
    tr = PPOTrainer(env, Dynamics(DynamicsConfig(**MODEL), "cpu"),
                    PPOConfig(**ppo))
    tr.init = lambda gen: (
        port_states(jinit[0]), history_from_jax(np_tree(jinit[1]), "cpu"),
        buffer_from_jax(np_tree(jinit[2]), "cpu"),
        ppo_state_from_jax(np_tree(jinit[3]), "cpu"),
        dynamics_state_from_jax(np_tree(jinit[4]), "cpu"))
    noise = [jax_noise(k_col) for k_col, _, _, _ in keys]
    perms = [jax_perms(jtr, k_ppo) for _, k_ppo, _, _ in keys]
    inject_fit_draws(tr, [d for _, _, k_fit, _ in keys
                          for d in jax_fit_keys(tr, k_fit)])
    modes = eval_modes
    evals = [port_states(jax_eval_states(jtr, k, mode))
             for *_, k_eval in keys
             for mode, k in zip(modes, jax.random.split(k_eval, len(modes)))]
    resets = JaxResets(jenv, jinit[0].rng,
                       None if shared is None else shared[2])
    eval_start = []

    def reset(gen, n, mode=0):
        """The collect's auto-resets from the JAX chain; the eval's start
        states (its auto-reset at the last step is never read)."""
        return resets.fresh if n == E else eval_start[-1]

    step = env.step

    def step_advancing(states, act, gen, mode=0):
        out = step(states, act, gen, mode)
        if out[3].shape[0] == E:
            resets.advance(out[3])
        return out

    env.reset, env.step = reset, step_advancing
    env.step_phys = physics.port_step_phys
    pcollects = []
    p_collect, p_update, p_eval = tr._collect, tr._ppo_update, tr.evaluate

    def collect_injected(*a):
        out = p_collect(*a, noise=noise.pop(0))
        pcollects.append(snapshot(out))
        return out

    def evaluate_injected(ps, dyn, mode, gen):
        eval_start.append(evals.pop(0))
        return p_eval(ps, dyn, mode, gen)

    tr._collect = collect_injected
    tr._ppo_update = lambda *a: p_update(*a, perms=perms.pop(0))
    tr.evaluate = evaluate_injected
    ps, dyn, rows = tr.train(torch.Generator())
    assert not noise and not perms and not evals
    return ((jps, jdyn, jrows, jcollects), (ps, dyn, rows, pcollects),
            physics, resets, jtr)


@pytest.fixture(scope="module")
def trained():
    """Both capacities' runs, the second taking over the first's physics
    and its JAX update and reset programs; the second runs no evals (its
    point is the second fit, on the wrapped ring)."""
    first = train_both(CAPACITIES[0])
    jax_run, port_run, physics, resets, jtr = first
    done = physics.restart()
    return {CAPACITIES[0]: (jax_run, port_run, done, resets),
            CAPACITIES[1]: train_both(CAPACITIES[1], (jtr, physics, resets),
                                      eval_modes=())[:-1]}


@pytest.fixture
def runs(trained):
    return trained[CAPACITIES[0]]


@pytest.fixture
def wrapped(trained):
    return trained[CAPACITIES[1]]


def close(a, b, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol, err_msg=msg)


def trees_close(port_tree, jax_tree, atol, msg=""):
    ours, ref = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(ours) == len(ref), msg
    for a, b in zip(ours, ref):
        close(a.detach().numpy(), b, atol, msg=msg)


ROW = ["itr", "collect/mean_episode_return", "collect/episodes",
       "collect/rollout_reward_per_env", "ppo/loss_first", "ppo/loss_last",
       "fit/model_loss_last", "fit/valid_loss", "eval/return_mode0",
       "eval/return_mode0_std"]


def test_physics_was_called_alike_at_every_step(runs):
    """Each package's env called ``step_phys`` 2 × (16 collect + 24 eval)
    times, in the same order, with the same hidden scales and with states
    and actions within tolerance."""
    *_, physics, _ = runs
    assert len(physics.calls) == physics.replayed == N_ITR * (T + HORIZON)
    assert physics.worst["qpos"] <= OBS_ATOL
    assert physics.worst["qvel"] <= OBS_ATOL
    assert physics.worst["act"] <= ACT_ATOL


def test_episodes_end_inside_and_across_collects(runs):
    """Env 3 and env 2 end in the first collect and env 1 and env 0 in
    the second, and each reset draws from the JAX env's key chain."""
    (_, _, jrows, jc), (_, _, rows, pc), _, resets = runs
    ends = [np.argwhere(c[3]["done"].numpy()).tolist() for c in pc]
    assert ends == [[[8, 3], [13, 2]], [[2, 1], [7, 0]]]
    assert [np.argwhere(np.asarray(c[3]["done"])).tolist()
            for c in jc] == ends
    assert resets.count == 4
    assert [r["collect/episodes"] for r in rows] == [2, 2]
    # the fresh episodes' hidden scales are the JAX env's draws
    for (s, *_), (js, *_) in zip(pc, jc):
        close(s.params.mass_scale, js.params.mass_scale, 0)
        close(s.params.damping_scale, js.params.damping_scale, 0)


@pytest.mark.parametrize("i", range(N_ITR), ids=["collect1", "collect2"])
def test_collect_state_matches_jax(runs, i):
    """The env states, histories, ring (contents, ptr and size),
    trajectory and bootstrap value after collect ``i``."""
    check_collect(runs, i, CAPACITIES[0])


def check_collect(runs, i, capacity):
    (*_, jc), (*_, pc), _, _ = runs
    (states, hists, buf, traj, last), (js, jh, jb, jtraj, jlast) = pc[i], jc[i]
    assert sorted(traj) == sorted(jtraj)
    for k in traj:
        assert traj[k].shape == jtraj[k].shape, k
        if k == "done":
            np.testing.assert_array_equal(traj[k].numpy(), np.asarray(jtraj[k]))
        else:
            close(traj[k], jtraj[k], OBS_ATOL, 1e-5, k)
    close(last, jlast, OBS_ATOL, 1e-5, "last_value")
    close(states.obs, js.obs, OBS_ATOL, msg="env obs")
    close(states.phys.qpos, js.phys.qpos, OBS_ATOL, msg="qpos")
    close(states.phys.qvel, js.phys.qvel, OBS_ATOL, msg="qvel")
    np.testing.assert_array_equal(states.t.numpy(), np.asarray(js.t))
    for f in ("obs", "dobs", "act"):
        close(getattr(hists, f), getattr(jh, f), OBS_ATOL, msg=f"history.{f}")
    np.testing.assert_array_equal(hists.valid.numpy(), np.asarray(jh.valid))
    for f in ("obs", "act", "next_obs"):
        close(getattr(buf, f), getattr(jb, f), OBS_ATOL, msg=f"ring.{f}")
    for f in ("done", "ep_step", "bad"):
        np.testing.assert_array_equal(getattr(buf, f).numpy(),
                                      np.asarray(getattr(jb, f)), f"ring.{f}")
    assert (buf.ptr, buf.size) == (int(jb.ptr), int(jb.size)) == (
        (i + 1) * T % capacity, min((i + 1) * T, capacity))


def test_metrics_rows_match_the_reference(runs):
    """Both iterations' rows key for key, in the reference's order."""
    check_rows(runs)


def check_rows(runs, keys=ROW):
    (_, _, jrows, _), (_, _, rows, _), _, _ = runs
    assert len(rows) == len(jrows) == N_ITR
    for row, jrow in zip(rows, jrows):
        assert list(row) == list(jrow) == keys
        for k, v in row.items():
            if k in ("itr", "collect/episodes"):
                assert v == jrow[k], k
            elif k.startswith(("ppo/", "fit/")):
                close(v, jrow[k], 0, LOSS_RTOL, k)
            else:   # sums and means of rewards: the obs tolerance per step
                close(v, jrow[k], OBS_ATOL * HORIZON, 1e-5, k)


def test_final_policy_value_and_model_match(runs):
    """The policy, log_std and value MLPs with their Adam state, and the
    model's params, norm and Adam state after two iterations."""
    check_final(runs)


def check_final(runs):
    (jps, jdyn, _, _), (ps, dyn, _, _), _, _ = runs
    assert ps.updates == int(jps.updates) == N_ITR * 2 * 2
    assert sorted(ps.params) == sorted(jps.params) == ["log_std", "policy",
                                                       "value"]
    for k in ps.params:
        trees_close(ps.params[k], jps.params[k], PARAM_ATOL, k)
    jadam = jps.opt_state[1][0]
    assert int(ps.opt_state.count) == int(jadam.count)
    trees_close(ps.opt_state.mu, jadam.mu, PARAM_ATOL, "ppo mu")
    trees_close(ps.opt_state.nu, jadam.nu, PARAM_ATOL, "ppo nu")
    assert dyn.updates == int(jdyn.updates) == N_ITR * 5
    trees_close(dyn.params, jdyn.params, PARAM_ATOL, "model")
    trees_close(dyn.norm.__dict__, jdyn.norm.__dict__, OBS_ATOL, "norm")
    trees_close(dyn.opt_state.mu, jdyn.opt_state[1][0].mu, PARAM_ATOL,
                "model mu")


@pytest.mark.parametrize("what", ["collect1", "collect2", "rows", "final"])
def test_wrapped_ring_matches_jax(wrapped, what):
    """The same two iterations on a 24-column ring, without evals: the
    second collect wraps it (ptr 8, size 24), so the second fit's norm,
    train and valid anchors and its valid batch come from a ring whose
    oldest column is physical column 8. Each collect's state, the rows and
    the final state as on the 64-column ring."""
    if what.startswith("collect"):
        check_collect(wrapped, int(what[-1]) - 1, CAPACITIES[1])
    elif what == "rows":
        check_rows(wrapped, ROW[:-2])
    else:
        check_final(wrapped)
    (*_, jc), (*_, pc), physics, _ = wrapped
    assert (pc[-1][2].ptr, pc[-1][2].size) == (8, 24)
    assert len(physics.calls) == physics.replayed == N_ITR * T
