"""The port's TS1 blow-up probe (``cadm_tpu_torch/analysis/probe_blowup.py``)
against scripts/probe_blowup.py on an untrained 5-member cartpole PE-TS +
CaDM snapshot whose normalization (Δobs std 20, action std 0.05) makes
its rollouts drift. Cartpole's healthy limits are infinite, so both
packages' ``CartPoleEnv`` get finite ones here and rows leave the envelope
at different steps. The
port starts from the reference collect's end state (``key(99)``) and takes
the script's candidate actions and per-step block permutations rebuilt from
``split(key(7), e)``: alive and non-finite fractions equal, max |pred|
within 1e-4 relative.
"""
import json

import jax
import numpy as np
import torch

from tests.torch_analysis_common import (
    env_states_to_torch,
    hists_to_torch,
    jax_cell,
    jax_random_start,
    snapshots,
)
import scripts.probe_blowup as jax_probe
import scripts.run_matrix as rm
from cadm_tpu.envs.cartpole import CartPoleEnv as JaxCartPole
from cadm_tpu_torch.analysis import probe_blowup
from cadm_tpu_torch.envs.cartpole import CartPoleEnv

CELL = "cartpole__pets_cadm__s0"
E, STEPS, C, N, H = 8, 12, 20, 5, 20   # H: the cartpole cell's plan_horizon
CM = C // N
MAX_RTOL = 1e-4


def script_draws(act_dim):
    """Each start state's actions (CM·N, H, act) and per-step permutations,
    as the script's ``rollout`` draws them from its key."""
    actions, perms = [], []
    for key in jax.random.split(jax.random.key(7), E):
        k_a, rng = jax.random.split(key)
        actions.append(jax.random.uniform(k_a, (CM * N, H, act_dim),
                                          minval=-1, maxval=1))
        p = []
        for _ in range(H):
            rng, k_perm = jax.random.split(rng)
            p.append(jax.random.permutation(k_perm, N))
        perms.append(np.stack(p))
    return (torch.from_numpy(np.array(jax.numpy.stack(actions))),
            torch.from_numpy(np.stack(perms)))


def test_rollout_stats_match_the_script(tmp_path, monkeypatch):
    for cls in (JaxCartPole, CartPoleEnv):
        monkeypatch.setattr(cls, "bad_obs_limit", 2.5, raising=False)
        monkeypatch.setattr(cls, "bad_dobs_limit", 0.3, raising=False)
    jstate, _ = snapshots(CELL, tmp_path, dobs_std=20.0, act_std=0.05)
    monkeypatch.setattr(rm, "CKPT_DIR", str(tmp_path))
    monkeypatch.setattr(jax_probe, "OUT_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr("sys.argv", [
        "probe_blowup.py", "--cell", CELL, "--n-envs", str(E), "--steps",
        str(STEPS), "--candidates", str(C)])
    jax_probe.main()
    with open(tmp_path / "jax" / (CELL + ".json")) as f:
        ref = json.load(f)

    env_j, _, _, trainer_j = jax_cell(CELL, n_envs=E, steps_per_itr=STEPS)
    jstates, jh = jax_random_start(trainer_j, jstate, jax.random.key(99))
    env = CartPoleEnv(device="cpu")
    actions, perms = script_draws(env_j.act_dim)
    out = probe_blowup.run_probe(
        CELL, E, STEPS, C, device="cpu", ckpt_dir=str(tmp_path),
        start=(env_states_to_torch(env, jstates), hists_to_torch(jh)),
        actions=actions, perms=perms)

    assert sorted(out) == sorted(ref)
    for key in ("cell", "n_start_states", "candidates", "members", "horizon",
                "alive_frac_by_step", "nonfinite_frac_by_step",
                "alive_frac_final"):
        assert out[key] == ref[key], key
    np.testing.assert_allclose(out["max_abs_pred_by_step"],
                               ref["max_abs_pred_by_step"], rtol=MAX_RTOL)
    # the limits bite: rows leave the envelope, at different steps
    alive = ref["alive_frac_by_step"]
    assert alive[0] > alive[-1] and len(set(alive)) > 2, alive


def test_unguarded_rollout_reports_non_finite_rows():
    """A member that predicts NaN: its block's rows count as non-finite and
    dead from that step on, max |pred| is inf, the others stay alive."""
    from cadm_tpu_torch.models.dynamics import (
        Dynamics,
        DynamicsConfig,
        DynamicsState,
        NormStats,
    )

    dyn = Dynamics(DynamicsConfig(obs_dim=3, act_dim=1, hidden=(8,),
                                  n_members=2), "cpu")
    state = dyn.init_state(torch.Generator().manual_seed(0))
    state.params["fwd"][-1]["b"][1] = float("nan")
    state = DynamicsState(state.params, NormStats.identity(3, 1))
    e, h = 2, 3
    perms = torch.tensor([[0, 1]]).expand(e, h, 2)  # block b → member b
    alive, mx, nonfin = probe_blowup.ts1_rollout_stats(
        dyn, state, torch.zeros(e, 3), torch.zeros(e, 0),
        torch.zeros(e, 4, h, 1), perms, 10.0, 10.0)
    assert alive.tolist() == [[0.5] * h] * e
    assert nonfin.tolist() == [[0.5] * h] * e
    assert torch.isinf(mx).all()
