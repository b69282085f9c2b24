"""The port's range-potency probe (``cadm_tpu_torch/analysis/
probe_ranges.py``) against scripts/probe_ranges.py: ``make_rollout`` under
the random policy on a cartpole whose obs index 1 (ẋ) stands for the
forward velocity and whose episodes last 40 steps (the same subclass on
both sides), at pinned scales 0.2 and 1.8, with the script's reset states
and actions rebuilt from its per-scale key: returns and velocity returns
within 1e-4 relative. Also that the pin replaces every params leaf
(CrippleAnt's actuator mask included, as the script's ``full_like``).
"""
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
