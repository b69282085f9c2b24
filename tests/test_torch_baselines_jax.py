"""The planned collect of the baselines against the JAX trainer's: Vanilla
(no context: a zero-width z, the window still pushed and wiped), Stacked
(the flat K-window fed to the heads), ReBAL (a GRU state carried through
``push_history``) and GrBAL (per-env weights adapted on the window at every
control step, planned through by each package's ``GrBALPlanner``).

The set-up is tests/torch_collect_common.py's: 4 deterministic cheetahs,
6 steps into a ring of 5 columns that wraps, 3-step episodes starting at
different ``t``, so dones fire mid-collect and each model's histories are
wiped on done; the JAX planner's ε is rebuilt from the collect's keys and
handed to the port. Both envs step through one physics (``SharedPhysics``:
the port's float32 step, the JAX env's through a host callback, memoised
by input bytes), each call's inputs held to the JAX env's; the physics is
held by its own tests, this file holds the model, the context, the planner
and the wipes.

After every control step, on both sides: the histories and the context the
planner gets (the window and GRU state as wiped after the last step; z,
or GrBAL's adapted net), the warm-start plan, the actions, the obs, the
rewards and dones; after the collect the env states, histories, ring and
metrics (``assert_collect_matches``). Tolerances: ``OBS_ATOL`` for
everything derived from obs, exact for the discrete parts.
"""
import jax
import numpy as np
import pytest
import torch

from cadm_tpu_torch.core.types import tree_leaves
from tests.torch_collect_common import (
    OBS_ATOL,
    STEPS,
    SharedPhysics,
    assert_collect_matches,
    jax_noise,
    setup,
)

BASE = dict(obs_dim=17, act_dim=6, hidden=(16, 16), history_k=3)
# (model config, GrBAL?)
MODELS = {
    "vanilla": (dict(BASE, context="none"), False),
    "stacked": (dict(BASE, context="stacked"), False),
    "rnn": (dict(BASE, context="rnn", z_dim=4, rnn_hidden=8), False),
    "grbal": (BASE, True),
}
HISTORY = ("obs", "dobs", "act", "valid", "rnn_h")


def record_jax(jtr):
    """Wrap the JAX trainer's context, plan and env step so that the
    jitted collect hands each step's values to the host, in order."""
    rec = {"ctx": [], "plan_mu": [], "step": []}
    model, planner = jtr.model, jtr.planner
    context, plan, step = (model.context_from_history, planner.plan,
                           jtr._step_collect)

    def keep(name):
        return lambda *x: rec[name].append(jax.tree.map(np.asarray, x))

    def context_rec(params, norm, hists):
        z = context(params, norm, hists)
        jax.debug.callback(
            keep("ctx"), {f: getattr(hists, f) for f in HISTORY}, z)
        return z

    def plan_rec(dyn_state, obs, z, key, plan_mu):
        jax.debug.callback(keep("plan_mu"), plan_mu)
        return plan(dyn_state, obs, z, key, plan_mu)

    def step_rec(states, actions):
        out = step(states, actions)
        jax.debug.callback(keep("step"), actions, out[1], out[2], out[3],
                           out[0].obs)
        return out

    model.context_from_history = context_rec
    planner.plan = plan_rec
    jtr._step_collect = step_rec
    return rec


def record_port(tr):
    """The same records of the port's collect."""
    rec = {"ctx": [], "plan_mu": [], "step": []}
    model, planner, env = tr.model, tr.planner, tr.env
    context, plan, step = (model.context_from_history, planner.plan,
                           env.step)

    def copy(v):
        if isinstance(v, dict):
            return {k: x.clone() for k, x in v.items()}
        if isinstance(v, list):     # GrBAL's adapted net
            return [x.clone() for x in tree_leaves(v)]
        return v.clone()

    def keep(name, *x):
        rec[name].append(tuple(copy(v) for v in x))

    def context_rec(params, norm, hists):
        z = context(params, norm, hists)
        keep("ctx", {f: getattr(hists, f) for f in HISTORY}, z)
        return z

    def plan_rec(state, obs, z, gen, prev_mu=None, **kw):
        keep("plan_mu", prev_mu)
        return plan(state, obs, z, gen, prev_mu, **kw)

    def step_rec(states, actions, gen, mode=0):
        out = step(states, actions, gen, mode)
        keep("step", actions, out[1], out[2], out[3], out[0].obs)
        return out

    model.context_from_history = context_rec
    planner.plan = plan_rec
    env.step = step_rec
    return rec


@pytest.fixture(scope="module")
def physics():
    """One memo of the port's physics steps for every case of the file."""
    return SharedPhysics()


@pytest.fixture(scope="module", params=list(MODELS))
def run(request, physics):
    """Both collects of one model, each compiled and run once →
    (model name, JAX out, port out, JAX records, port records, the physics
    calls)."""
    model, grbal = MODELS[request.param]
    jtr, jargs, tr, args = setup(model, grbal, physics)
    jrec, rec = record_jax(jtr), record_port(tr)
    rng = jax.random.key(5)
    noise = torch.stack([jax_noise(k) for k in jax.random.split(rng, STEPS)])
    jout = jtr._collect_plan(rng, *jargs)
    out = tr._collect(torch.Generator().manual_seed(0), *args,
                      random_actions=False, noise=noise)
    return request.param, jout, out, jrec, rec, physics.restart()


def close(ours, ref, msg, atol=OBS_ATOL, rtol=0.0):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=msg)


def test_planned_collect_matches_jax(run):
    """The env states, histories (the GRU state among them), ring and
    metrics after the collect; the physics called alike at every step."""
    _, jout, out, _, _, physics = run
    assert_collect_matches(jout, out)
    assert len(physics.calls) == physics.replayed == STEPS
    assert max(physics.worst.values()) <= OBS_ATOL
    # the ring wrapped: 6 steps into 5 columns
    assert (out[2].ptr, out[2].size) == (1, 5)


def test_every_control_step_matches_jax(run):
    """Step by step: the histories and context the planner got, the
    warm-start plan, the actions, obs, rewards and dones."""
    _, _, _, jrec, rec, _ = run
    for kind in rec:
        assert len(rec[kind]) == len(jrec[kind]) == STEPS, kind
    for t in range(STEPS):
        (hists, z), (jhists, jz) = rec["ctx"][t], jrec["ctx"][t]
        for f in HISTORY:
            ours = hists[f]
            if f == "valid":
                np.testing.assert_array_equal(ours.numpy(), jhists[f],
                                              err_msg=f"step {t} {f}")
            else:
                close(ours, jhists[f], f"step {t} history.{f}")
        jz = jax.tree.leaves(jz)
        z = z if isinstance(z, list) else [z]
        assert len(z) == len(jz) and [x.shape for x in z] == [
            x.shape for x in jz]
        for i, (a, b) in enumerate(zip(z, jz)):
            close(a, b, f"step {t} context leaf {i}")
        close(rec["plan_mu"][t][0], jrec["plan_mu"][t][0],
              f"step {t} plan_mu")
        (act, obs, reward, done, reset_obs) = rec["step"][t]
        (jact, jobs, jreward, jdone, jreset_obs) = jrec["step"][t]
        close(act, jact, f"step {t} actions")
        close(obs, jobs, f"step {t} obs")
        close(reset_obs, jreset_obs, f"step {t} obs after auto-reset")
        close(reward, jreward, f"step {t} reward", rtol=1e-5)
        np.testing.assert_array_equal(done.numpy(), jdone,
                                      err_msg=f"step {t} done")


def test_histories_are_wiped_on_done(run):
    """Each done mid-collect wipes the env's histories (window and GRU
    state) before the next plan, on both sides; some of the wiped ones
    held a pushed transition (and a non-zero GRU state for ReBAL)."""
    name, _, _, jrec, rec, _ = run
    wiped_live = 0
    for r, as_np in ((rec, lambda x: x.numpy()), (jrec, np.asarray)):
        for t in range(STEPS - 1):
            done = as_np(r["step"][t][3])
            for e in np.flatnonzero(done):
                before, after = r["ctx"][t][0], r["ctx"][t + 1][0]
                for f in HISTORY:
                    assert not as_np(after[f])[e].any(), (t, e, f)
                if as_np(before["valid"])[e].any():
                    wiped_live += 1
                    if name == "rnn":
                        assert as_np(before["rnn_h"])[e].any()
    # before the last step: env 2 (t = 2) ends at steps 0 and 3, env 1 at 1
    # and 4, envs 0 and 3 at 2; all but env 2's first with a pushed
    # transition, on each side
    assert wiped_live == 2 * 5
