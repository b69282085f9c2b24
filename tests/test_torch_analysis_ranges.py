"""The port's range-potency probe (``cadm_tpu_torch/analysis/
probe_ranges.py``) against scripts/probe_ranges.py: ``make_rollout`` under
the random policy on a cartpole whose obs index 1 (ẋ) stands for the
forward velocity and whose episodes last 40 steps (the same subclass on
both sides), at pinned scales 0.2 and 1.8, with the script's reset states
and actions rebuilt from its per-scale key: returns and velocity returns
within 1e-4 relative. Also that the pin replaces every params leaf
(CrippleAnt's actuator mask included, as the script's ``full_like``).
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_analysis_common import env_states_to_torch, jax_reset
import scripts.probe_ranges as jax_probe
from cadm_tpu.envs.cartpole import CartPoleEnv as JaxCartPole
from cadm_tpu_torch.analysis import probe_ranges
from cadm_tpu_torch.envs import make
from cadm_tpu_torch.envs.cartpole import CartPoleEnv

N, HORIZON = 6, 40
RTOL = 1e-4


class VxJaxCartPole(JaxCartPole):
    horizon = HORIZON
    _vx_index = 1


class VxCartPole(CartPoleEnv):
    horizon = HORIZON
    _vx_index = 1


@pytest.mark.parametrize("scale", [0.2, 1.8])
def test_random_policy_rollout_matches_the_script(scale):
    env_j = VxJaxCartPole()
    run_j = jax.jit(jax_probe.make_rollout(env_j, N,
                                           jax_probe.random_policy(env_j)))
    key = jax.random.key(probe_ranges.scale_seed(scale))
    ref_ret, ref_vel = map(np.asarray, run_j(jnp.asarray(scale), key))

    r_reset, r_run = jax.random.split(key)
    env = VxCartPole(device="cpu")
    start = env_states_to_torch(env, jax_reset(env_j, jax.random.split(
        r_reset, N)))
    actions = torch.from_numpy(np.array(jnp.stack([
        jax.random.uniform(k, (N, env.act_dim), minval=-1.0, maxval=1.0)
        for k in jax.random.split(r_run, HORIZON)])))
    run = probe_ranges.make_rollout(
        env, N, probe_ranges.random_policy(env, actions))
    ret, vel = run(scale, torch.Generator().manual_seed(0), start)
    assert np.abs(ref_vel).min() > 0
    np.testing.assert_allclose(ret.numpy(), ref_ret, rtol=RTOL)
    np.testing.assert_allclose(vel.numpy(), ref_vel, rtol=RTOL)


def test_the_pin_replaces_every_params_leaf():
    """CrippleAnt's act_mask becomes all ``scale``, as under the script's
    ``tree_map(full_like)``; one control step at 2 envs."""
    env = make("cripple_ant", device="cpu")
    seen = []

    def act(states, aux, gen, t):
        seen.append(states.params.act_mask.clone())
        return torch.zeros(2, env.act_dim), aux

    policy = {"init": lambda n: None, "act": act,
              "post": lambda aux, prev, obs, a: aux}
    ret, vel = probe_ranges.make_rollout(env, 2, policy, horizon=1)(
        0.5, torch.Generator().manual_seed(0))
    assert torch.equal(seen[0], torch.full((2, env.act_dim), 0.5))
    assert torch.isfinite(ret).all() and torch.isfinite(vel).all()


def test_scale_sweep_records_n_the_returns_and_the_wall_time():
    env = VxCartPole(device="cpu")
    out = probe_ranges.scale_sweep(
        env, 3, {"random": probe_ranges.random_policy(env)}, horizon=5,
        scales=[0.2])
    rec = out["0.2"]["random"]
    assert rec["n"] == len(rec["returns"]) == 3 and rec["wall_s"] > 0
    assert rec["return_mean"] == pytest.approx(np.mean(rec["returns"]))
    assert rec["return_std"] == pytest.approx(np.std(rec["returns"]))


def test_cross_eval_npz_layout_and_the_two_se_rule():
    """scripts/cross_eval_ranges.py: the npz keys carry the params tree
    (lists by index) and the six norm fields back unchanged; at a scale
    the packages agree iff |Δmean| ≤ 2·√(SE_port² + SE_jax²)."""
    import scripts.cross_eval_ranges as cross

    rng = np.random.RandomState(0)
    params = {"encoder": [{"w": rng.randn(3, 2), "b": rng.randn(2)}] * 2,
              "fwd": [{"w": rng.randn(1, 2, 2), "b": rng.randn(1, 2)}]}
    norm = {"obs_mean": rng.randn(3), "dobs_std": rng.rand(3)}
    arrays = {**cross.flatten(params, "params"), **cross.flatten(norm, "norm")}
    assert "params/encoder/1/w" in arrays
    back = cross.unflatten(arrays, "params")
    assert isinstance(back["encoder"], list) and len(back["encoder"]) == 2
    np.testing.assert_array_equal(back["fwd"][0]["w"],
                                  params["fwd"][0]["w"].astype(np.float32))
    assert sorted(cross.unflatten(arrays, "norm")) == sorted(norm)

    def side(returns):
        return {"runs": {"4": {"1.0": {"return_mean": float(np.mean(returns)),
                                       "n": len(returns),
                                       "returns": list(returns)}}}}

    jax_ = side([0.0, 2.0, 4.0, 6.0])      # SE √(20/3)/2 = 1.291
    bound = 2 * np.sqrt(2) * np.sqrt(20 / 3) / 2
    for shift, agree in ((bound - 1e-6, True), (bound + 1e-6, False)):
        v = cross.verdict(side([shift + x for x in (0.0, 2.0, 4.0, 6.0)]),
                          jax_)["port n=4 vs jax n=4"]["1.0"]
        assert v["bound"] == pytest.approx(bound) and v["agree"] is agree
    # pooled: a larger env count repeats a smaller one's episodes (the
    # script's keys split per env), each counted once; plain-kernel runs
    # stay out
    more = side([0.0, 2.0, 4.0, 6.0, 1.0, 3.0, 5.0, 7.0])["runs"]["4"]
    plain = {"1.0": {"return_mean": 1e4, "n": 1, "returns": [1e4]}}
    jax_["runs"].update({"8": more, "4 key1": more})
    pool = cross.pooled({"runs": dict(jax_["runs"], **{"4 plain-kernels":
                                                        plain})})["1.0"]
    assert pool["n"] == 8 and pool["return_mean"] == pytest.approx(3.5)


def test_cross_eval_vanilla_cell_has_no_context(tmp_path, monkeypatch):
    """A Vanilla cell (``context='none'``): ``--side export`` of the matrix
    runner's snapshot gives back its params (no encoder) and norm bit for
    bit, and ``--side port`` on the CPU plans a pinned scale through them
    at the cell's width. Its files carry the cell's name; the first cell's
    (``port.json``) are not touched."""
    import scripts.cross_eval_ranges as cross
    from cadm_tpu_torch.analysis.snapshot import cell_config
    from cadm_tpu_torch.cli import matrix
    from cadm_tpu_torch.core.types import tree_leaves

    cell = "half_cheetah__vanilla__s1"
    monkeypatch.setattr(cross, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(matrix, "CKPT_DIR", str(tmp_path / "ckpt"))
    _, model, _, _ = cell_config(cell).build("cpu")
    assert model.cfg.context == "none"
    dyn = model.init_state(torch.Generator().manual_seed(1))
    matrix.save_snapshot(cell, dyn)
    cross.main(["--side", "export", "--cell", cell, "--ckpt",
                str(tmp_path / "ckpt" / f"{cell}.pt")])
    params, norm, policy, _ = cross.read_npz(cell)
    assert policy is None and "encoder" not in params
    for ours, ref in ((params, dyn.params), (norm, dyn.norm.__dict__)):
        a, b = jax.tree.leaves(ours), tree_leaves(ref)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y.numpy())
    cross.main(["--side", "port", "--cell", cell, "--device", "cpu",
                "--n-envs", "2", "--horizon", "2", "--scales", "0.5"])
    with open(tmp_path / f"{cell}.port.json") as f:
        side = json.load(f)
    assert side["cell"] == cell and side["horizon"] == 2
    rec = side["runs"]["2 cpu"]["0.5"]
    assert rec["n"] == 2 and np.isfinite(rec["returns"]).all()
    assert not (tmp_path / "port.json").exists()


# ------------------------------------------- the PPO cross-evaluation --
PPO_CELL = "half_cheetah__ppo_cadm__s4"


def toy_ppo_cheetah():
    """A toy PPO + CaDM cheetah trainer on the CPU and its initial PPO and
    model states (2 envs)."""
    from cadm_tpu_torch.cli.presets import ExperimentConfig

    cfg = ExperimentConfig(trainer="ppo", env="half_cheetah", model="cadm",
                           hidden=(16, 16), policy_hidden=(16, 16), n_envs=2,
                           eval_envs=2, env_horizon=3, buffer_capacity=8)
    env, _, _, tr = cfg.build("cpu")
    gen = torch.Generator().manual_seed(0)
    *_, ps, dyn = tr.init(gen)
    return env, tr, ps, dyn, gen


def test_ppo_policy_acts_as_the_trainers_eval_step():
    """``ppo_policy`` under ``make_rollout`` takes the actions
    ``PPOTrainer._eval_step`` takes from the same weights and start state,
    bit for bit, and the rollout's returns are ``evaluate``'s from those
    start states."""
    env, tr, ps, dyn, gen = toy_ppo_cheetah()
    start = probe_ranges.pinned(env.reset(gen, 2, 0), 0.5)
    assert torch.equal(start.params.mass_scale, torch.full((2,), 0.5))
    policy = probe_ranges.ppo_policy(tr, ps, dyn)
    states, hists = start, policy["init"](2)
    s2, h2 = start, policy["init"](2)
    for t in range(3):
        act, hists = policy["act"](states, hists, gen, t)
        prev = states.obs
        states, obs, _, _ = env.step(states, act, gen, 0)
        hists = policy["post"](hists, prev, obs, act)
        s2, h2, act2, obs2, _, _ = tr._eval_step(ps, dyn, s2, h2, gen, 0)
        assert torch.equal(act, act2) and torch.equal(obs, obs2)
        assert torch.equal(hists.obs, h2.obs) and act.abs().max() <= 1
    ret, _ = probe_ranges.make_rollout(env, 2, policy)(0.5, gen, start)
    assert torch.equal(ret, tr.evaluate(ps, dyn, 0, gen, start=start))
    # the cross-evaluation's sweep: the trainer's eval and the rollout of
    # ppo_policy give the same episodes, pinned and on mode 0
    sweeps = [probe_ranges.ppo_sweep(tr, ps.params, dyn, [0.5], graph=g)
              for g in (True, False)]
    assert sorted(sweeps[0]) == ["0.5", "mode0"]
    for k, rec in sweeps[0].items():
        assert rec["returns"] == sweeps[1][k]["returns"] and rec["n"] == 2


def test_cross_eval_ppo_npz_holds_the_policy_tree(tmp_path, monkeypatch):
    """``--side export`` of a PPO cell, from the port's snapshot (the
    matrix runner's, ``ppo`` beside the model) and from the JAX runner's
    two pickles: the npz gives back the model's params and norm and the
    PPO params tree bit for bit; ``--side port`` on the CPU then runs the
    pinned scales and mode 0 at the cell's width."""
    import optax

    import scripts.cross_eval_ranges as cross
    import scripts.run_jax_cpu_cell as jax_cell
    import scripts.run_matrix as rm
    from cadm_tpu.cli.presets import ExperimentConfig as JaxConfig
    from cadm_tpu.models.nets import mlp_init as jax_mlp_init
    from cadm_tpu.train.ppo import PPOState as JaxPPOState
    from cadm_tpu_torch.analysis.snapshot import cell_config
    from cadm_tpu_torch.cli import matrix
    from cadm_tpu_torch.core.types import tree_leaves
    from cadm_tpu_torch.models.dynamics import AdamState
    from cadm_tpu_torch.models.nets import mlp_init
    from cadm_tpu_torch.train.ppo import PPOState

    monkeypatch.setattr(cross, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(matrix, "CKPT_DIR", str(tmp_path / "ckpt"))
    _, model, _, tr = cell_config(PPO_CELL).build("cpu")
    gen = torch.Generator().manual_seed(1)
    dyn = model.init_state(gen)
    params = {"policy": mlp_init(gen, [tr._pol_in, 64, 64, 6]),
              "log_std": torch.full((6,), -0.5),
              "value": mlp_init(gen, [tr._pol_in, 64, 64, 1])}
    matrix.save_snapshot(PPO_CELL, dyn, PPOState(
        params, AdamState.zeros_like(params), 3))
    cross.main(["--side", "export", "--cell", PPO_CELL, "--ckpt",
                str(tmp_path / "ckpt" / f"{PPO_CELL}.pt")])
    p, norm, policy, _ = cross.read_npz(f"{PPO_CELL}__port")
    assert sorted(policy) == ["log_std", "policy", "value"]
    for ours, ref in ((p, dyn.params), (policy, params),
                      (norm, dyn.norm.__dict__)):
        a, b = jax.tree.leaves(ours), tree_leaves(ref)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y.numpy())

    # the JAX runner's pickles of a JAX-trained cell
    jcfg = dict(rm.FAMILY_BASE["half_cheetah"], **rm.MODEL_VARIANTS["ppo_cadm"])
    _, jmodel, _, jtr = JaxConfig(**jcfg).build()
    k1, k2, k3 = jax.random.split(jax.random.key(2), 3)
    jparams = {"policy": jax_mlp_init(k1, [jtr._pol_in, 64, 64, 6]),
               "log_std": jnp.full((6,), -0.5),
               "value": jax_mlp_init(k2, [jtr._pol_in, 64, 64, 1])}
    jdyn = jmodel.init_state(k3)
    monkeypatch.setattr(rm, "CKPT_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(jax_cell, "CKPT_DIR", str(tmp_path / "jax"))
    rm.save_snapshot(PPO_CELL, jdyn)
    jax_cell.save_ppo_state(PPO_CELL, JaxPPOState(
        params=jparams, opt_state=jtr.tx.init(jparams),
        updates=jnp.asarray(0, jnp.int32)))
    assert isinstance(jtr.tx, optax.GradientTransformation)
    cross.main(["--side", "export", "--cell", PPO_CELL, "--trained-by", "jax",
                "--ckpt", str(tmp_path / "jax" / f"{PPO_CELL}.pkl")])
    p, norm, policy, _ = cross.read_npz(f"{PPO_CELL}__jax")
    for ours, ref in ((p, jdyn.params), (policy, jparams)):
        a, b = jax.tree.leaves(ours), jax.tree.leaves(ref)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y))

    cross.main(["--side", "port", "--cell", PPO_CELL, "--device", "cpu",
                "--n-envs", "2", "--horizon", "2", "--scales", "0.5"])
    with open(tmp_path / f"{PPO_CELL}__port.port.json") as f:
        side = json.load(f)
    assert side["trained_by"] == "port" and side["horizon"] == 2
    runs = side["runs"]["2 cpu"]
    assert sorted(runs) == ["0.5", "mode0"]
    for rec in runs.values():
        assert rec["n"] == 2 and np.isfinite(rec["returns"]).all()
        assert rec["device"] == "cpu"


def test_cross_eval_table_sets_each_policy_beside_the_other(tmp_path,
                                                            monkeypatch):
    """``--side table``: each policy by each package (pooled), and within
    a package each pair of policies against the 2-SE bound."""
    import scripts.cross_eval_ranges as cross

    monkeypatch.setattr(cross, "OUT_DIR", str(tmp_path))

    def side(returns):
        return {"runs": {"4": {"mode0": {"return_mean": float(np.mean(
            returns)), "n": len(returns), "returns": returns}}}}

    cells = {"half_cheetah__ppo_cadm__s4__port": ([10.0, 12.0], [11.0, 13.0]),
             "half_cheetah__ppo_cadm__s3__jax": ([0.0, 2.0], [1.0, 3.0])}
    for name, (port, jax_) in cells.items():
        cross.write_side(f"{name}.port", side(port))
        cross.write_side(f"{name}.jax", side(jax_))
    out = cross.table(argparse.Namespace(cell="half_cheetah__ppo_cadm"))
    assert out["policies"]["half_cheetah__ppo_cadm__s4__port"]["jax"][
        "mode0"]["mean"] == 12.0
    pair = out["pairs"]["half_cheetah__ppo_cadm__s3__jax vs "
                        "half_cheetah__ppo_cadm__s4__port, evaluated by port"]
    assert pair["mode0"]["delta"] == -10.0 and not pair["mode0"]["agree"]
    assert (tmp_path / "half_cheetah__ppo_cadm.table.json").exists()
