"""The MB trainer's eval episode (``MBTrainer.evaluate`` →
``step_graph.eval_step``) against the JAX trainer's ``_eval_impl``, for
Vanilla, CaDM, Stacked, ReBAL and GrBAL in eval modes 0, 1 and 2.

The set-up is tests/torch_collect_common.py's, on a deterministic cheetah
whose episodes last 6 steps, so that the K=3 window fills and then slides.
Its reset pins the hidden scales to one point inside each mode's range of
``MASS_DAMPING_SCALE`` (cadm_tpu/envs/ranges.py), so every mode's reset
and every mode's env step (the JAX trainer's ``_step_eval[mode]``, the
port's ``env.step(..., mode)``) are taken. An episode also ends when the
root's x passes ``X_END``, so some envs end mid-eval, auto-reset and carry
on, while others run to the horizon. Both envs step through one physics
(``SharedPhysics``), which holds each call's scales exactly. The JAX eval's
ε is rebuilt from its keys (``_eval_impl`` splits its run key into one key
a step, each handed to ``planner.plan``) and given to the port's
``evaluate(noise=)``.

Each model's JAX eval is compiled once, for all three modes: the mode is
a traced index, which picks the pinned scales of a reset and switches
(``lax.switch``) to the trainer's own ``_step_eval`` of that mode.

At every step, on both sides: the histories and the context the planner
gets (z, or GrBAL's adapted net), the warm-start plan, the actions, obs,
rewards, dones and reset scales, and the histories after
``push_history``; at the end the returns, masked at each env's first done.
The eval does not wipe the histories or the plan on done. Tolerances: the
collect tests' ``OBS_ATOL`` for everything derived from obs, exact for the
discrete parts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cadm_tpu.envs.rigid_base import MassDampingParams as JaxParams
from cadm_tpu_torch.core.types import tree_leaves
from cadm_tpu_torch.envs.rigid_base import MassDampingParams
from tests.test_torch_baselines_jax import HISTORY
from tests.test_torch_baselines_jax import MODELS as BASELINES
from tests.torch_collect_common import (
    MODEL,
    OBS_ATOL,
    DetCheetah,
    DetJaxCheetah,
    SharedPhysics,
    jax_noise,
    setup,
)

# (model config, GrBAL?): CaDM's encoder, and the four baselines (Vanilla's
# zero-width context among them)
MODELS = {"cadm": (MODEL, False), **BASELINES}
MODES = (0, 1, 2)
HORIZON = 6
# (mass, damping) inside the train, moderate and extreme ranges of
# MASS_DAMPING_SCALE: train (0.75, 1.25), moderate [0.40, 0.75] ∪ [1.25,
# 1.60], extreme [0.20, 0.40] ∪ [1.60, 1.80]
MODE_SCALES = ((1.1, 0.9), (0.5, 1.5), (1.7, 0.3))
# the root's x (qpos[0], not in the obs) past which an episode ends
X_END = 0.03


class TracedMode:
    """An eval mode as a traced index, for one program of every mode."""

    def __init__(self, index):
        self.index = index


def pinned_scales(mode):
    """The (mass, damping) of ``mode``: an int, or a ``TracedMode``."""
    index = mode.index if isinstance(mode, TracedMode) else mode
    table = jnp.asarray(MODE_SCALES, jnp.float32)
    return table[index, 0], table[index, 1]


class EvalJaxCheetah(DetJaxCheetah):
    horizon = HORIZON

    def sample_params(self, rng, mode):
        return JaxParams(*pinned_scales(mode))

    def terminated(self, params, phys, obs):
        return phys.qpos[0] > X_END


class EvalCheetah(DetCheetah):
    horizon = HORIZON

    def sample_params(self, gen, mode, n):
        mass, damping = MODE_SCALES[mode]
        return MassDampingParams(torch.full((n,), mass),
                                 torch.full((n,), damping))

    def terminated(self, params, phys, obs):
        return phys.qpos[:, 0] > X_END


def steps_by_mode(jtr, keep):
    """``jtr._step_eval`` indexed by a ``TracedMode``: a switch over the
    trainer's own step of each mode, its results handed to ``keep``."""
    steps = [jtr._step_eval[m] for m in MODES]

    class ByMode:
        def __getitem__(self, mode):
            def step(states, actions):
                out = lax.switch(mode.index, steps, states, actions)
                nxt, obs, reward, done = out
                jax.debug.callback(
                    keep, actions, obs, reward, done, nxt.obs,
                    nxt.params.mass_scale, nxt.params.damping_scale)
                return out
            return step

    return ByMode()


def record_jax(jtr):
    """Wrap the JAX trainer's context, plan, env step and history push so
    that the jitted eval hands each step's values to the host, in order."""
    rec = {"ctx": [], "plan_mu": [], "step": [], "pushed": []}
    model, planner = jtr.model, jtr.planner
    context, plan, push = (model.context_from_history, planner.plan,
                           model.push_history)

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

    def push_rec(params, norm, hists, obs, dobs, act):
        out = push(params, norm, hists, obs, dobs, act)
        jax.debug.callback(keep("pushed"),
                           {f: getattr(out, f) for f in HISTORY})
        return out

    model.context_from_history = context_rec
    planner.plan = plan_rec
    model.push_history = push_rec
    jtr._step_eval = steps_by_mode(jtr, keep("step"))
    return rec


def record_port(tr):
    """The same records of the port's eval."""
    rec = {"ctx": [], "plan_mu": [], "step": [], "pushed": []}
    model, planner, env = tr.model, tr.planner, tr.env
    context, plan, step, push = (model.context_from_history, planner.plan,
                                 env.step, model.push_history)

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
        nxt = out[0]
        keep("step", actions, out[1], out[2], out[3], nxt.obs,
             nxt.params.mass_scale, nxt.params.damping_scale)
        return out

    def push_rec(params, norm, hists, obs, dobs, act):
        out = push(params, norm, hists, obs, dobs, act)
        keep("pushed", {f: getattr(out, f) for f in HISTORY})
        return out

    model.context_from_history = context_rec
    planner.plan = plan_rec
    env.step = step_rec
    model.push_history = push_rec
    return rec


@pytest.fixture(scope="module")
def physics():
    """One memo of the port's physics steps for every case of the file."""
    return SharedPhysics()


@pytest.fixture(scope="module", params=list(MODELS))
def run(request, physics):
    """One model's evals in every mode, the JAX one compiled once →
    (model name, {mode: (JAX returns, port returns, JAX records, port
    records, the physics calls)})."""
    model, grbal = MODELS[request.param]
    jtr, jargs, tr, args = setup(model, grbal, physics,
                                 (EvalJaxCheetah, EvalCheetah))
    jdyn, dyn = jargs[3], args[3]
    jrec, rec = record_jax(jtr), record_port(tr)
    jeval = jax.jit(lambda rng, st, m: jtr._eval_impl(rng, st, TracedMode(m)))
    jeval = jeval.lower(jax.random.key(0), jdyn, 0).compile()
    out = {}
    for mode in MODES:
        rng = jax.random.key(10 + mode)
        _, r_run = jax.random.split(rng)
        noise = torch.stack([jax_noise(k)
                             for k in jax.random.split(r_run, HORIZON)])
        jret = np.asarray(jeval(rng, jdyn, mode))
        ret = tr.evaluate(dyn, mode, torch.Generator().manual_seed(0),
                          noise=noise)
        # each record holds every mode's run so far, in turn
        for r in (jrec, rec):
            assert {len(v) for v in r.values()} == {HORIZON * (mode + 1)}
        out[mode] = (jret, ret, *({k: v[-HORIZON:] for k, v in r.items()}
                                  for r in (jrec, rec)), physics.restart())
    return request.param, out


def close(ours, ref, msg, atol=OBS_ATOL, rtol=0.0):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=msg)


def exact(ours, ref, msg):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref), err_msg=msg)


def close_histories(hists, jhists, msg):
    for f in HISTORY:
        (exact if f == "valid" else close)(hists[f], jhists[f],
                                           f"{msg} history.{f}")


@pytest.mark.parametrize("mode", MODES)
def test_every_eval_step_matches_jax(run, mode):
    """Step by step: the histories and context the planner got, the
    warm-start plan, the actions, obs, rewards, dones and reset scales,
    and the histories after the push; the physics called alike, at the
    mode's pinned scales."""
    _, runs = run
    _, _, jrec, rec, physics = runs[mode]
    assert len(physics.calls) == physics.replayed == HORIZON
    assert max(physics.worst.values()) <= OBS_ATOL
    mass, damping = np.float32(MODE_SCALES[mode])
    for (ms, ds, *_), _ in physics.calls:
        assert (ms == mass).all() and (ds == damping).all()
    for t in range(HORIZON):
        (hists, z), (jhists, jz) = rec["ctx"][t], jrec["ctx"][t]
        close_histories(hists, jhists, f"step {t}")
        jz = jax.tree.leaves(jz)
        z = z if isinstance(z, list) else [z]
        assert len(z) == len(jz) and [x.shape for x in z] == [
            x.shape for x in jz]
        for i, (a, b) in enumerate(zip(z, jz)):
            close(a, b, f"step {t} context leaf {i}")
        close(rec["plan_mu"][t][0], jrec["plan_mu"][t][0],
              f"step {t} plan_mu")
        act, obs, reward, done, reset_obs, ms, ds = rec["step"][t]
        jact, jobs, jreward, jdone, jreset_obs, jms, jds = jrec["step"][t]
        close(act, jact, f"step {t} actions")
        close(obs, jobs, f"step {t} obs")
        close(reset_obs, jreset_obs, f"step {t} obs after auto-reset")
        close(reward, jreward, f"step {t} reward", rtol=1e-5)
        exact(done, jdone, f"step {t} done")
        exact(ms, jms, f"step {t} mass scale")
        exact(ds, jds, f"step {t} damping scale")
        close_histories(rec["pushed"][t][0], jrec["pushed"][t][0],
                        f"step {t} pushed")


@pytest.mark.parametrize("mode", MODES)
def test_eval_returns_match_jax(run, mode):
    """The returns, each env's rewards up to and including its first done
    (the ``alive`` mask), on both sides; some env ended mid-eval and was
    stepped on."""
    _, runs = run
    jret, ret, _, rec, _ = runs[mode]
    close(ret, jret, "returns", rtol=1e-5)
    rewards = torch.stack([r[2] for r in rec["step"]])
    dones = torch.stack([r[3] for r in rec["step"]]).float()
    alive = torch.cumprod(torch.cat([torch.ones(1, dones.shape[1]),
                                     1.0 - dones[:-1]]), dim=0)
    torch.testing.assert_close(ret, (rewards * alive).sum(0))
    assert (dones[:-1].sum(0) > 0).any(), "no env ended mid-eval"


def test_eval_keeps_the_histories_and_plan_through_a_done(run):
    """A done mid-eval wipes neither the window nor the warm-start plan:
    the next step's context reads the pushed window and the plan carries
    on (on both sides); the window fills and slides."""
    name, runs = run
    kept = 0
    for mode in MODES:
        _, _, jrec, rec, _ = runs[mode]
        for r, as_np in ((rec, lambda x: x.numpy()), (jrec, np.asarray)):
            for t in range(HORIZON - 1):
                done = as_np(r["step"][t][3])
                for e in np.flatnonzero(done):
                    nxt = r["ctx"][t + 1][0]
                    for f in HISTORY:
                        np.testing.assert_array_equal(
                            as_np(nxt[f])[e], as_np(r["pushed"][t][0][f])[e])
                    assert as_np(nxt["valid"])[e].any()
                    assert as_np(r["plan_mu"][t + 1][0])[e].any()
                    kept += 1
            # the window is full from step 3 on and slides
            assert as_np(r["ctx"][HORIZON - 1][0]["valid"]).all()
    assert kept > 0, name
