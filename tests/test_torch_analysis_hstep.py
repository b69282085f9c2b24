"""The port's open-loop H-step probe (``cadm_tpu_torch/analysis/
probe_hstep.py``) against scripts/probe_hstep.py on an untrained cartpole
snapshot, CaDM (1 member) and PE-TS + CaDM (5 probabilistic members): the
port starts from the reference collect's end state (``trainer.init`` and a
random collect from ``key(99)``) and takes ``key(7)``'s actions, so every
list of the record agrees after the script's own rounding to 4 decimals.
"""
import jax
import numpy as np
import pytest
import torch

from tests.torch_analysis_common import (
    env_states_to_torch,
    hists_to_torch,
    jax_cell,
    jax_random_start,
    snapshots,
)
from scripts.probe_hstep import run_probe as jax_run_probe
from cadm_tpu_torch.analysis import probe_hstep

# float32 MLP rollouts over 6 open-loop steps, normalized by the real
# trajectory's std, then rounded to 4 decimals by both
ATOL = 2e-4
E, H, STEPS = 4, 6, 30


@pytest.mark.parametrize("model", ["cadm", "pets_cadm"])
def test_run_probe_matches_the_script(model, tmp_path):
    cell = f"cartpole__{model}__s0"
    jstate, _ = snapshots(cell, tmp_path)
    pkl = str(tmp_path / (cell + ".pkl"))
    ref = jax_run_probe(cell, ckpt_path=pkl, n_envs=E, horizon=H,
                        collect_steps=STEPS)

    env_j, _, _, trainer_j = jax_cell(cell, n_envs=E, steps_per_itr=STEPS)
    jstates, jh = jax_random_start(trainer_j, jstate, jax.random.key(99))
    actions = jax.random.uniform(jax.random.key(7), (H, E, env_j.act_dim),
                                 minval=-1, maxval=1)
    env = probe_hstep.load_cell(cell, pkl, "cpu")[1]
    out = probe_hstep.run_probe(
        cell, pkl, E, H, STEPS, device="cpu",
        start=(env_states_to_torch(env, jstates), hists_to_torch(jh)),
        actions=torch.from_numpy(np.array(actions)))

    assert sorted(out) == sorted(ref)
    assert out["members"] == (5 if model == "pets_cadm" else 1)
    for key, want in ref.items():
        if isinstance(want, str):
            assert out[key] == want
        else:
            np.testing.assert_allclose(out[key], want, atol=ATOL, rtol=0,
                                       err_msg=key)
    assert ref["openloop_nmse_mean"] > 1e-3  # not trivially zero
    if model == "pets_cadm":
        assert ref["member_spread_final"] > 0


def test_the_probe_draws_its_own_start_and_actions(tmp_path):
    """Without injection: a seeded random collect and uniform actions; one
    seed gives one record."""
    cell = "cartpole__pets_cadm__s0"
    snapshots(cell, tmp_path)
    runs = [probe_hstep.run_probe(cell, n_envs=E, horizon=H,
                                  collect_steps=12, seed=s, device="cpu",
                                  ckpt_dir=str(tmp_path)) for s in (3, 3, 4)]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert runs[0]["alive_frac_by_step"] == [1.0] * H
    assert all(np.isfinite(runs[0]["openloop_nmse_by_step"]))
