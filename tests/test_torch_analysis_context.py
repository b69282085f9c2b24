"""The port's context probe (``cadm_tpu_torch/analysis/probe_context.py``)
against scripts/probe_context.py: the closed-form decoders on seeded numpy
inputs (within 1e-12), the decode targets of a seeded CrippleAnt params
batch (equal), z of an untrained cartpole CaDM snapshot on one injected
history (within 1e-5), and the whole random-policy probe on the moderate
range, the port's collector given the script's reset states and actions
rebuilt from its keys (each round's ``split(rng)`` of ``key(1234)``): the
held-out R² of every target within 1e-6. Also the collector's wipe of a
history on done.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_analysis_common import (
    env_states_to_torch,
    jax_cell,
    jax_reset,
    snapshots,
)
import scripts.probe_context as jax_probe
import scripts.run_matrix as rm
from cadm_tpu.core.types import History as JaxHistory
from cadm_tpu.envs.ant import CrippleParams as JaxCrippleParams
from cadm_tpu_torch.analysis import probe_context
from cadm_tpu_torch.core.types import History
from cadm_tpu_torch.envs.ant import CrippleParams
from cadm_tpu_torch.envs.cartpole import CartPoleEnv

CELL = "cartpole__cadm__s0"
Z_ATOL, R2_ATOL, DECODER_ATOL = 1e-5, 1e-6, 1e-12


def test_decoders_match_the_script():
    rng = np.random.RandomState(0)
    z = rng.randn(60, 10)
    y = z @ rng.randn(10) + 0.3 * rng.randn(60)
    assert abs(probe_context.ridge_r2(z, y) - jax_probe.ridge_r2(z, y)) \
        <= DECODER_ATOL
    labels = rng.randint(0, 3, 60).astype(np.float64)
    z_lab = z + labels[:, None]
    ours = probe_context.onehot_accuracy(z_lab, labels)
    ref = jax_probe.onehot_accuracy(z_lab, labels)
    assert ours[2] == ref[2] == 3
    np.testing.assert_allclose(ours[:2], ref[:2], rtol=0, atol=DECODER_ATOL)


def test_targets_from_params_match_the_script():
    """CrippleAnt's leg ids from seeded masks (a row with no leg zeroed is
    -1); cartpole's continuous params as they are."""
    rng = np.random.RandomState(1)
    mask = np.ones((12, 8), np.float32)
    legs = rng.randint(0, 4, 12)
    for i, leg in enumerate(legs[:-1]):
        mask[i, probe_context.LEG_ACTUATORS[leg]] = 0.0
    ours = probe_context.targets_from_params(
        "cripple_ant", CrippleParams(torch.from_numpy(mask)))
    ref = jax_probe.targets_from_params(
        "cripple_ant", JaxCrippleParams(jnp.asarray(mask)))
    assert sorted(ours) == sorted(ref) == ["crippled_leg"]
    np.testing.assert_array_equal(ours["crippled_leg"], ref["crippled_leg"])
    assert ours["crippled_leg"][-1] == -1

    env_j = jax_cell(CELL)[0]
    jstates = jax_reset(env_j, jax.random.split(jax.random.key(2), 5))
    states = env_states_to_torch(CartPoleEnv(device="cpu"), jstates)
    ours = probe_context.targets_from_params("cartpole", states.params)
    ref = jax_probe.targets_from_params("cartpole", jstates.params)
    assert sorted(ours) == sorted(ref) == ["force_mag", "length"]
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_z_on_an_injected_history_matches(tmp_path):
    jstate, state = snapshots(CELL, tmp_path, dobs_std=0.5, act_std=0.8)
    _, jdyn, _, _ = jax_cell(CELL)
    _, _, dyn, _, _, _ = probe_context.load_cell(CELL, device="cpu",
                                                 ckpt_dir=str(tmp_path))
    rng = np.random.RandomState(3)
    e, k = 6, jdyn.cfg.history_k
    obs, dobs = (rng.randn(e, k, 5).astype(np.float32) for _ in range(2))
    act = rng.uniform(-1, 1, (e, k, 1)).astype(np.float32)
    valid = (np.arange(k)[None] >= rng.randint(0, k, (e, 1))).astype(
        np.float32)   # partial windows: the oldest slots empty
    ref = jdyn.context_from_history(jstate.params, jstate.norm, JaxHistory(
        *map(jnp.asarray, (obs, dobs, act, valid)), jnp.zeros((e, 0))))
    z = dyn.context_from_history(state.params, state.norm, History(
        *map(torch.from_numpy, (obs, dobs, act, valid)), torch.zeros(e, 0)))
    np.testing.assert_allclose(z.numpy(), np.asarray(ref), atol=Z_ATOL)


def script_draws(env_j, n_envs, steps, rounds, mode):
    """Each round's reset states and actions (steps, E, act), as the
    script's ``collect_mode`` draws them from ``key(1234)``."""
    rng, starts, actions = jax.random.key(1234), [], []
    for _ in range(rounds):
        rng, k = jax.random.split(rng)
        r_reset, r_run = jax.random.split(k)
        starts.append(jax_reset(env_j, jax.random.split(r_reset, n_envs),
                                mode))
        actions.append(torch.from_numpy(np.array(jnp.stack([
            jax.random.uniform(kk, (n_envs, env_j.act_dim), minval=-1.0,
                               maxval=1.0)
            for kk in jax.random.split(r_run, steps)]))))
    return starts, actions


def test_random_policy_probe_matches_the_script(tmp_path, monkeypatch):
    n_envs, steps, rounds, mode = 48, 12, 2, 1
    snapshots(CELL, tmp_path, dobs_std=0.5, act_std=0.8)
    monkeypatch.setattr(rm, "CKPT_DIR", str(tmp_path))
    monkeypatch.setattr(jax_probe, "OUT_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr("sys.argv", [
        "probe_context.py", "--cell", CELL, "--rounds", str(rounds),
        "--mode", str(mode), "--n-envs", str(n_envs), "--steps", str(steps)])
    jax_probe.main()
    with open(tmp_path / "jax" / f"{CELL}__mode{mode}.json") as f:
        ref = json.load(f)

    env_j = jax_cell(CELL)[0]
    jstarts, actions = script_draws(env_j, n_envs, steps, rounds, mode)
    env = CartPoleEnv(device="cpu")
    out, _, _ = probe_context.run_probe(
        CELL, rounds, False, mode, n_envs, steps, "cpu", str(tmp_path),
        starts=[env_states_to_torch(env, s) for s in jstarts],
        actions=actions, log=lambda *a: None)
    assert sorted(out) == sorted(ref) and out["policy"] == "random"
    assert out["n_windows"] == ref["n_windows"] == rounds * n_envs
    assert (out["z_dim"], out["mode"]) == (ref["z_dim"], mode)
    assert sorted(out["targets"]) == sorted(ref["targets"])
    for name, want in ref["targets"].items():
        assert out["targets"][name]["decoder"] == want["decoder"] == "ridge"
        assert abs(out["targets"][name]["held_out_r2"]
                   - want["held_out_r2"]) <= R2_ATOL, name


@pytest.mark.parametrize("horizon", [5, 300])
def test_the_collector_wipes_a_history_on_done(tmp_path, horizon):
    """12 steps of 5-step episodes leave 2 transitions in every window (no
    full window); with no done every window is full."""
    cell = "cartpole__cadm__s0"
    snapshots(cell, tmp_path)
    cfg, env, dyn, _, _, state = probe_context.load_cell(
        cell, device="cpu", ckpt_dir=str(tmp_path), env_horizon=horizon)
    env_states, hists = probe_context.collect_random(
        env, dyn, state, 4, 12, 0, torch.Generator().manual_seed(0))
    want = 12 % horizon if horizon < 12 else min(12, cfg.history_k)
    assert hists.valid.sum(-1).tolist() == [want] * 4
    assert env_states.t.tolist() == [12 % horizon] * 4
    z, tgts = probe_context.full_windows(dyn, state, env_states, hists,
                                         "cartpole")
    assert z.shape[0] == (0 if horizon < 12 else 4) == len(tgts["length"])
