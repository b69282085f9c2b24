"""The port's PPO + CaDM trainer against the JAX package's (on pendulum, as
tests/test_infra.py runs the reference's): the policy's ``_dist``/``_logp``
and value on converted weights, GAE, one whole PPO update, a collect, the
model fit, an eval and one whole iteration's metrics row, with the JAX
draws rebuilt from its keys and injected (ε from ``split(split(rng, T)[t])
[0]``, the permutations from ``split(k_ppo, ppo_epochs)``, the segment
indices as tests/test_torch_fit.py rebuilds them, the eval's start states
from its reset keys). Also the reference test's end-to-end contract
(``updates`` = itr × epochs × minibatches), the models PPO refuses, a
bit-exact resume and the CLI.
"""
import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadm_tpu.envs.pendulum import PendulumEnv as JaxPendulum
from cadm_tpu.envs.pendulum import PendulumParams as JaxPendulumParams
from cadm_tpu.envs.pendulum import PendulumPhys as JaxPendulumPhys
from cadm_tpu.models.dynamics import Dynamics as JaxDynamics
from cadm_tpu.models.dynamics import DynamicsConfig as JaxConfig
from cadm_tpu.models.dynamics import NormStats as JaxNorm
from cadm_tpu.models.nets import mlp_apply as jax_mlp_apply
from cadm_tpu.train.ppo import PPOConfig as JaxPPOConfig
from cadm_tpu.train.ppo import PPOTrainer as JaxPPOTrainer
from cadm_tpu_torch.cli import run
from cadm_tpu_torch.cli.presets import ExperimentConfig
from cadm_tpu_torch.core.types import EnvState, History, tree_leaves
from cadm_tpu_torch.envs.pendulum import PendulumEnv, PendulumParams, PendulumPhys
from cadm_tpu_torch.models.dynamics import Dynamics, DynamicsConfig, DynamicsState
from cadm_tpu_torch.train.buffer import ReplayBuffer
from cadm_tpu_torch.train.ppo import PPOConfig, PPOTrainer
from cadm_tpu_torch.utils.checkpoint import Checkpointer
from cadm_tpu_torch.utils.convert import (
    adam_state_from_jax,
    params_from_jax,
    ppo_state_from_jax,
)

# float32 MLPs and one control step: 1e-6 relative; GAE sums of O(10)
# values, the update's params after 4 Adam steps at lr 3e-4 and the fit's
# after 5 at lr 1e-3: 1e-5 (the model tests' tolerance); losses 1e-5
# relative. The eval runs 200 control steps of the closed loop, where
# rounding differences grow: returns of O(1000) within 1e-4 relative.
ATOL, GAE_ATOL, PARAM_ATOL, LOSS_RTOL, EVAL_RTOL = 1e-6, 1e-5, 1e-5, 1e-5, 1e-4
E, T, EVAL_ENVS = 4, 16, 3
MODEL = dict(obs_dim=3, act_dim=1, hidden=(16, 16), context="encoder",
             z_dim=4, history_k=4, future_m=3, encoder_hidden=(16,))
PPO = dict(n_envs=E, rollout_len=T, n_itr=1, policy_hidden=(16, 16),
           ppo_epochs=2, minibatches=2, model_updates_per_itr=5,
           model_batch=8, buffer_capacity=64, eval_envs=EVAL_ENVS,
           eval_modes=(0, 2))


class DetJaxPendulum(JaxPendulum):
    """Six-step episodes restarting from one fixed state: episodes end
    inside a collect and restart identically on both sides."""
    horizon = 6

    def sample_params(self, rng, mode):
        return JaxPendulumParams(jnp.float32(1.15), jnp.float32(0.85))

    def init_phys(self, rng, params):
        return JaxPendulumPhys(jnp.float32(2.5), jnp.float32(-0.3))


class DetPendulum(PendulumEnv):
    horizon = 6

    def sample_params(self, gen, mode, n):
        return PendulumParams(torch.full((n,), 1.15), torch.full((n,), 0.85))

    def init_phys(self, gen, params):
        n = params.mass.shape[0]
        return PendulumPhys(torch.full((n,), 2.5), torch.full((n,), -0.3))


def trainers(det=False, model="cadm", **ppo):
    context = {"cadm": "encoder", "vanilla": "none"}[model]
    cfg = {**PPO, **ppo}
    jenv, env = ((DetJaxPendulum(), DetPendulum(device="cpu")) if det
                 else (JaxPendulum(), PendulumEnv(device="cpu")))
    jtr = JaxPPOTrainer(jenv, JaxDynamics(JaxConfig(**{**MODEL,
                                                       "context": context})),
                        JaxPPOConfig(**cfg))
    tr = PPOTrainer(env, Dynamics(DynamicsConfig(**{**MODEL,
                                                    "context": context}),
                                  "cpu"), PPOConfig(**cfg))
    return jtr, tr


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


def port_states(js):
    par = PendulumParams(t(js.params.mass), t(js.params.length))
    phys = PendulumPhys(t(js.phys.theta), t(js.phys.theta_dot))
    return EnvState(phys=phys, obs=t(js.obs), params=par, t=t(js.t),
                    done=t(js.done))


def port_hists(jh):
    return History(t(jh.obs), t(jh.dobs), t(jh.act), t(jh.valid), t(jh.rnn_h))


def port_buffer(jb):
    return ReplayBuffer(t(jb.obs), t(jb.act), t(jb.next_obs), t(jb.done),
                        t(jb.ep_step), t(jb.bad), int(jb.ptr), int(jb.size))


def port_dyn(jd):
    params, norm = params_from_jax(np_tree(jd.params), np_tree(jd.norm), "cpu")
    return DynamicsState(params, norm,
                         adam_state_from_jax(np_tree(jd.opt_state[1][0]),
                                             "cpu"), int(jd.updates))


def port_init(init):
    js, jh, jb, jps, jd = init
    return (port_states(js), port_hists(jh), port_buffer(jb),
            ppo_state_from_jax(np_tree(jps), "cpu"), port_dyn(jd))


def jax_init(jtr, key=0):
    """The JAX trainer's initial state with a random norm, so that the
    context z is not a function of zeros."""
    init = list(jtr.init(jax.random.key(key)))
    rng = np.random.RandomState(key)
    init[4] = init[4].replace(norm=JaxNorm(*(
        jnp.asarray(rng.uniform(lo, hi, n).astype(np.float32))
        for lo, hi, n in ((-1, 1, 3), (0.5, 2, 3), (-1, 1, 1), (0.5, 2, 1),
                          (-0.2, 0.2, 3), (0.1, 1, 3)))))
    return init


def jax_noise(rng, steps=T):
    """The collect's ε: its scan key of step t, split, first half."""
    return torch.stack([t(jax.random.normal(jax.random.split(k)[0], (E, 1)))
                        for k in jax.random.split(rng, steps)])


def jax_perms(jtr, rng, n):
    return torch.stack([t(jax.random.permutation(k, n)) for k in
                        jax.random.split(rng, jtr.cfg.ppo_epochs)])


def inject_fit_draws(tr, rng):
    """Make ``tr._draw`` return the segment indices the JAX ``_fit_model``
    draws from ``rng``: one train batch per update, then a valid batch."""
    r_train, r_valid = jax.random.split(rng)
    keys = [("train", k) for k in jax.random.split(
        r_train, tr.cfg.model_updates_per_itr)] + [("valid", r_valid)]

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
    return keys


def jax_eval_states(jtr, rng, mode):
    r_reset, _ = jax.random.split(rng)
    return jax.vmap(lambda k: jtr.env.reset(k, mode))(
        jax.random.split(r_reset, jtr.cfg.eval_envs))


def inject_eval_resets(tr, states_by_mode):
    """``tr.env.reset`` of ``eval_envs`` envs in mode m gives the JAX
    eval's start states; the collect's unused auto-reset draws keep the
    generator."""
    reset = tr.env.reset

    def injected(gen, n, mode=0):
        if n == tr.cfg.eval_envs:
            return port_states(states_by_mode[mode])
        return reset(gen, n, mode)

    tr.env.reset = injected


def close(a, b, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol, err_msg=msg)


def trees_close(port_tree, jax_tree, atol):
    ours, ref = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        close(a.detach().numpy(), b, atol)


@pytest.fixture(scope="module")
def collected():
    """The pendulum trainers, their start state and one JAX collect."""
    jtr, tr = trainers()
    init = jax_init(jtr)
    rng = jax.random.key(5)
    out = jtr._collect(rng, *init)
    return jtr, tr, init, rng, out


def test_dist_logp_value_on_converted_weights(collected):
    jtr, tr, init, _, _ = collected
    jps = init[3]
    ps = ppo_state_from_jax(np_tree(jps), "cpu")
    assert ps.updates == 0 and ps.opt_state.count == 0
    assert ps.params["log_std"].tolist() == [-0.5]
    rng = np.random.RandomState(0)
    obs_z = rng.randn(32, 7).astype(np.float32)
    act = rng.uniform(-1, 1, (32, 1)).astype(np.float32)
    jmean, jlog_std = jtr._dist(jps.params, jnp.asarray(obs_z))
    mean, log_std = tr._dist(ps.params, t(obs_z))
    close(mean, jmean, ATOL)
    close(log_std, jlog_std, 0)
    close(tr._logp(mean, log_std, t(act)),
          jtr._logp(jmean, jlog_std, jnp.asarray(act)), ATOL, 1e-6)
    jvalue = jax_mlp_apply(jps.params["value"], jnp.asarray(obs_z),
                           activation=jnp.tanh)[..., 0]
    close(tr._value(ps.params, t(obs_z)), jvalue, ATOL)


@pytest.mark.parametrize("det", [False, True], ids=["pendulum",
                                                    "episodes_end_inside"])
def test_collect_matches_jax(det, collected):
    """A collect with the same start states, weights and ε: on pendulum
    (no auto-reset inside 16 steps), and with 6-step episodes ending at
    different steps (returns reported, histories wiped, envs restarted)."""
    if det:
        jtr, tr = trainers(det=True)
        init = jax_init(jtr)
        init[0] = init[0].replace(t=jnp.array([0, 1, 2, 3], jnp.int32))
        rng = jax.random.key(6)
        jstates, jhists, jbuf, jtraj, jlast = jtr._collect(rng, *init)
    else:
        jtr, tr, init, rng, (jstates, jhists, jbuf, jtraj, jlast) = collected
    states, hists, buf, ppo_state, dyn = port_init(init)
    states, hists, buf, traj, last = tr._collect(
        torch.Generator(), states, hists, buf, ppo_state, dyn,
        noise=jax_noise(rng))
    assert sorted(traj) == sorted(jtraj)
    for k in traj:
        assert traj[k].shape == jtraj[k].shape, k
        np.testing.assert_allclose(traj[k].numpy(), np.asarray(jtraj[k]),
                                   atol=1e-5, rtol=1e-6, err_msg=k)
    close(last, jlast, 1e-5, 1e-6)
    close(states.obs, jstates.obs, 1e-5)
    np.testing.assert_array_equal(states.t.numpy(), np.asarray(jstates.t))
    for a, b in zip((hists.obs, hists.dobs, hists.act, hists.valid),
                    (jhists.obs, jhists.dobs, jhists.act, jhists.valid)):
        close(a, b, 1e-5)
    for f in ("obs", "act", "next_obs", "done", "ep_step", "bad"):
        close(getattr(buf, f), getattr(jbuf, f), 1e-5, msg=f)
    assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))
    n_done = int(traj["done"].sum())
    assert n_done == (10 if det else 0)  # 2 + 2 + 3 + 3 episode ends
    assert int(np.isfinite(traj["ep_return"].numpy()).sum()) == n_done


def test_gae_matches_jax():
    jtr, tr = trainers()
    rng = np.random.RandomState(2)
    traj = {"reward": rng.randn(T, E).astype(np.float32),
            "value": rng.randn(T, E).astype(np.float32) * 3,
            "done": rng.rand(T, E) < 0.15}
    last = rng.randn(E).astype(np.float32)
    jadv, jret = jtr._gae({k: jnp.asarray(v) for k, v in traj.items()},
                          jnp.asarray(last))
    adv, ret = tr._gae({k: t(v) for k, v in traj.items()}, t(last))
    close(adv, jadv, GAE_ATOL)
    close(ret, jret, GAE_ATOL)
    # normalized by the population std
    assert abs(adv.std(correction=0).item() - 1.0) < 1e-5


def test_ppo_update_matches_jax_with_the_same_permutations(collected):
    jtr, tr, init, _, (_, _, _, jtraj, jlast) = collected
    jtraj = {k: v for k, v in jtraj.items() if k != "ep_return"}
    rng = jax.random.key(7)
    jps, jmet = jtr._ppo_update(rng, init[3], jtraj, jlast)
    ps = ppo_state_from_jax(np_tree(init[3]), "cpu")
    ps, met = tr._ppo_update(torch.Generator(), ps,
                             {k: t(v) for k, v in jtraj.items()}, t(jlast),
                             perms=jax_perms(jtr, rng, T * E))
    assert ps.updates == int(jps.updates) == 4
    assert list(met) == ["ppo/loss_first", "ppo/loss_last"] == sorted(jmet)
    for k in met:
        close(float(met[k]), float(jmet[k]), 0, LOSS_RTOL, k)
    trees_close(ps.params, jps.params, PARAM_ATOL)
    trees_close(ps.opt_state.mu, jps.opt_state[1][0].mu, PARAM_ATOL)
    assert ps.opt_state.count == int(jps.opt_state[1][0].count)


def test_fit_model_matches_jax_with_the_same_indices(collected):
    jtr, tr, init, _, (_, _, jbuf, _, _) = collected
    rng = jax.random.key(8)
    jdyn, jmet = jtr._fit_model(rng, jbuf, init[4])
    keys = inject_fit_draws(tr, rng)
    dyn, met = tr._fit_model(torch.Generator(), port_buffer(jbuf),
                             port_dyn(init[4]))
    assert not keys and list(met) == sorted(jmet)
    for k in met:
        close(float(met[k]), float(jmet[k]), 1e-5, 1e-5, k)
    trees_close(dyn.params, jdyn.params, PARAM_ATOL)
    trees_close(dyn.norm.__dict__, jdyn.norm.__dict__, 1e-5)
    assert dyn.updates == int(jdyn.updates) == 5


def test_eval_matches_jax_from_the_same_start_states(collected):
    """200 steps of the deterministic mean on mode 2 (the extreme range)."""
    jtr, tr, init, _, _ = collected
    rng = jax.random.key(9)
    jret = jtr._evals[2](rng, init[3], init[4])
    inject_eval_resets(tr, {2: jax_eval_states(jtr, rng, 2)})
    _, _, _, ps, dyn = port_init(init)
    ret = tr.evaluate(ps, dyn, 2, torch.Generator())
    assert ret.shape == (EVAL_ENVS,)
    close(ret, jret, 0, EVAL_RTOL)


def test_one_iteration_row_matches_the_reference():
    """``train`` for one iteration with every JAX draw rebuilt from its
    keys: the same metrics row, keys in the reference's order."""
    jtr, tr = trainers()
    rng = jax.random.key(11)
    _, _, (jrow,) = jtr.train(rng)
    r_init, r = jax.random.split(rng)
    _, k_col, k_ppo, k_fit, k_eval = jax.random.split(r, 5)
    init = jtr.init(r_init)
    tr.init = lambda gen: port_init(init)
    collect, update = tr._collect, tr._ppo_update
    tr._collect = lambda *a: collect(*a, noise=jax_noise(k_col))
    tr._ppo_update = lambda *a: update(*a, perms=jax_perms(jtr, k_ppo, T * E))
    inject_fit_draws(tr, k_fit)
    inject_eval_resets(tr, {
        mode: jax_eval_states(jtr, k, mode)
        for mode, k in zip(PPO["eval_modes"], jax.random.split(k_eval, 2))})
    ps, dyn, (row,) = tr.train(torch.Generator())
    assert list(row) == list(jrow) == [
        "itr", "collect/mean_episode_return", "collect/episodes",
        "collect/rollout_reward_per_env", "ppo/loss_first", "ppo/loss_last",
        "fit/model_loss_last", "fit/valid_loss", "eval/return_mode0",
        "eval/return_mode0_std", "eval/return_mode2", "eval/return_mode2_std"]
    for k, v in row.items():
        if k.endswith("_std"):  # a spread of returns of O(1000)
            close(v, jrow[k], 1e-3 * abs(jrow[k.replace("_std", "")]), 0, k)
        elif k.startswith("eval/"):
            close(v, jrow[k], 0, EVAL_RTOL, k)
        elif np.isnan(jrow[k]):
            assert np.isnan(v), k
        else:
            close(v, jrow[k], 1e-5, 1e-5, k)
    assert ps.updates == 4 and dyn.updates == 5


def test_ppo_cadm_end_to_end_counts_minibatch_updates():
    """As the reference's test_ppo_cadm_end_to_end (tests/test_infra.py):
    two iterations, finite losses, ``updates`` = itr × epochs ×
    minibatches, pendulum returns in their band on each eval range."""
    _, tr = trainers(n_itr=2, rollout_len=32, model_updates_per_itr=10,
                     buffer_capacity=128, eval_envs=4)
    ps, dyn, hist = tr.train(torch.Generator().manual_seed(0))
    assert len(hist) == 2 and ps.updates == 2 * 2 * 2
    assert dyn.updates == 2 * 10
    for k in ("ppo/loss_last", "fit/model_loss_last", "fit/valid_loss"):
        assert np.isfinite(hist[-1][k]), k
    for mode in (0, 2):
        assert np.isfinite(hist[-1][f"eval/return_mode{mode}_std"])
        assert -4000 < hist[-1][f"eval/return_mode{mode}"] < 0


def test_vanilla_ppo_reads_no_context_but_fits_the_model():
    """``model='vanilla'``: the policy reads obs alone (z has width 0), and
    the fit still trains a model nothing reads, as in the reference."""
    jtr, tr = trainers(model="vanilla")
    assert tr._pol_in == 3 == jtr._pol_in
    ps, dyn, (row,) = tr.train(torch.Generator().manual_seed(0))
    assert ps.params["policy"][0]["w"].shape == (3, 16)
    assert dyn.updates == 5 and np.isfinite(row["fit/model_loss_last"])


@pytest.mark.parametrize("model", ["rnn", "grbal"])
def test_ppo_refuses_the_models_the_reference_refuses(model):
    cfg = ExperimentConfig(trainer="ppo", env="pendulum", model=model,
                           n_envs=2, eval_envs=2)
    with pytest.raises(KeyError, match="ported"):
        cfg.build("cpu")


def test_resume_reproduces_the_uninterrupted_row_bit_for_bit(tmp_path):
    cfg = dict(n_itr=3, rollout_len=8, eval_envs=2, eval_modes=(0,))
    env_h = 12
    ckpt = Checkpointer(str(tmp_path / "ck"), keep=5)
    _, tr = trainers(**cfg)
    tr.env.horizon = env_h
    _, dyn_full, full = tr.train(torch.Generator().manual_seed(3),
                                 checkpointer=ckpt)
    restored = Checkpointer(str(tmp_path / "ck")).restore(step=1)
    assert restored["itr"] == 1 and restored["ppo_state"]["updates"] == 8
    _, tr = trainers(**cfg)
    tr.env.horizon = env_h
    ps, dyn, resumed = tr.train(torch.Generator().manual_seed(99),
                                resume=restored)
    assert [r["itr"] for r in resumed] == [2]
    assert resumed[0] == full[2]
    assert ps.updates == 12 and dyn.updates == dyn_full.updates
    for a, b in zip(tree_leaves(dyn.params), tree_leaves(dyn_full.params)):
        assert torch.equal(a, b)


PPO_ROW = ["itr", "collect/mean_episode_return", "collect/episodes",
           "collect/rollout_reward_per_env", "ppo/loss_first", "ppo/loss_last",
           "fit/model_loss_last", "fit/valid_loss", "eval/return_mode0",
           "eval/return_mode0_std", "eval/return_mode1",
           "eval/return_mode1_std", "eval/return_mode2",
           "eval/return_mode2_std"]


def test_cli_trains_ppo_checkpoints_and_resumes(tmp_path):
    """``--trainer ppo`` through the CLI on the CPU: the reference's row,
    ``--dump-trajs`` ignored, ``--checkpoint`` then ``--resume``."""
    argv = ["--trainer", "ppo", "--env", "pendulum", "--model", "cadm",
            "--device", "cpu", "--hidden", "8,8", "--policy-hidden", "8,8",
            "--n-envs", "2", "--eval-envs", "2", "--rollout-len", "6",
            "--env-horizon", "5", "--ppo-epochs", "2",
            "--ppo-minibatches", "2", "--model-updates-per-itr", "3",
            "--batch-size", "4", "--buffer-capacity", "20",
            "--log-dir", str(tmp_path), "--exp-name", "ppo"]
    full = run.main(argv + ["--n-itr", "2", "--checkpoint", "--dump-trajs"])
    with open(tmp_path / "ppo" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 and list(rows[0]) == PPO_ROW
    assert all(row[k] not in ("", "nan") for row in rows for k in PPO_ROW
               if k != "collect/mean_episode_return")
    assert not (tmp_path / "ppo" / "trajectories.bin").exists()
    resumed = run.main(argv + ["--n-itr", "3", "--resume"])
    assert [r["itr"] for r in full] == [0, 1]
    assert [r["itr"] for r in resumed] == [2]
