"""Step the port beside the JAX package on one trained model, step by step.

A CPU diagnostic for ``scripts/cross_eval_ranges.py``: where the two
packages' returns at a pinned scale differ, this tells acting apart from
sampling. The JAX package drives: it resets ``--n-envs`` half_cheetahs,
pins mass and damping to the scale, and rolls its planner (the cell's CEM
through the model in ``results/torch/cross_eval/<cell>.npz``) with its own
env. At every step the port is given the same inputs — the history the
JAX rollout pushed, the JAX plan's warm-start mean, the JAX planner's
truncated-normal draws (rebuilt from its key, as tests/test_torch_planner.py
does), and the JAX env state with the JAX action — and the script prints
the largest differences of context, action, plan mean, next obs and
reward, and each step where an action or an obs differs by more than 1e-3.
For such an action it replays that env's CEM iterations with both packages
scoring the same candidates and prints the returns at the elite cut; for
such an obs it steps that env alone in the JAX package too. Like the
parity tests it imports both packages.

    JAX_PLATFORMS=cpu python scripts/cross_eval_lockstep.py --scales 0.5 \\
        --n-envs 4 --steps 1000

About 1.6 s a step at 4 envs on 4 cores, after ≈ 30 s of compiling.

A PPO + CaDM cell (``--cell half_cheetah__ppo_cadm__s4 --trained-by
port|jax``, the npz of ``cross_eval_ranges.py --side export``) runs
``PPOLockstep``: the JAX package drives its eval policy, the port acts on
the same obs and history and steps the JAX state with the JAX action, and
the summary adds each env's episode sum of the port's reward minus the JAX
package's on those same states and actions.
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import scripts.cross_eval_ranges as cross  # noqa: E402
from cadm_tpu.cli.presets import ExperimentConfig  # noqa: E402
from cadm_tpu.models.dynamics import DynamicsState as JaxState  # noqa: E402
from cadm_tpu.models.dynamics import NormStats as JaxNorm  # noqa: E402
from cadm_tpu.train.mb_trainer import batched_history as jax_history  # noqa: E402
from cadm_tpu_torch.analysis.snapshot import cell_config  # noqa: E402
from cadm_tpu_torch.core.types import batched_history  # noqa: E402
from cadm_tpu_torch.models.dynamics import DynamicsState, NormStats  # noqa: E402
from cadm_tpu_torch.utils.convert import params_from_jax  # noqa: E402
from scripts.run_matrix import FAMILY_BASE, MODEL_VARIANTS  # noqa: E402
from tests.torch_analysis_common import (  # noqa: E402
    env_states_to_torch,
    hists_to_torch,
)

FLAG = 1e-3   # an action or obs this far apart is printed and explained


def as_torch(x):
    return torch.from_numpy(np.array(x))


class Lockstep:
    def __init__(self, cell: str):
        family, model, seed = cross.cell_kwargs(cell)
        params_np, norm_np, _, _ = cross.read_npz(cell)
        cfg = ExperimentConfig(**FAMILY_BASE[family], **MODEL_VARIANTS[model],
                               seed=seed, eval_modes=(0, 1, 2))
        self.jenv, self.jm, self.jp, _ = cfg.build()
        self.jstate = JaxState(
            params=jax.tree.map(jnp.asarray, params_np), opt_state=None,
            norm=JaxNorm(**{k: jnp.asarray(v) for k, v in norm_np.items()}),
            updates=jnp.asarray(0, jnp.int32))
        tcfg = cell_config(cell)
        self.env, self.m, self.p, _ = tcfg.build("cpu")
        params, norm = params_from_jax(params_np, NormStats(**norm_np), "cpu")
        self.state = DynamicsState(params, norm)
        self.c, self.h, self.iters = (tcfg.n_candidates, tcfg.plan_horizon,
                                      tcfg.cem_iters)
        js, jm, jp = self.jstate, self.jm, self.jp
        self.plan = jax.jit(lambda o, z, k, mu: jp.plan(js, o, z, k, mu))
        self.ctx = jax.jit(lambda h: jm.context_from_history(
            js.params, js.norm, h))
        self.push = jax.jit(lambda h, o, d, a: jm.push_history(
            js.params, js.norm, h, o, d, a))
        self.step = jax.jit(jax.vmap(lambda s, a: self.jenv.step(s, a, 0)))
        self.evaluate = jax.jit(lambda o, z, a: jp._evaluate(
            js.params, js.norm, o, z, a, jax.random.key(0)))

    def eps(self, key, n):
        """The JAX planner's ε of one plan, (iters, n, C, H, act): per env
        ``split(key, n)``, per iteration ``split(k_env, iters)``, the first
        half of each iteration key's split (``_plan_single``)."""
        shape = (self.c, self.h, self.env.act_dim)
        return np.array(np.stack([np.stack([
            np.asarray(jax.random.truncated_normal(
                jax.random.split(k)[0], -2.0, 2.0, shape))
            for k in jax.random.split(k_env, self.iters)])
            for k_env in jax.random.split(key, n)], axis=1))

    def elite_cut(self, obs, z, prev_mu, eps):
        """One env's CEM iterations, the port refitting, both packages
        scoring the same candidates: per iteration the returns' largest
        difference, whether the elite sets agree, and the returns at the
        cut (the last elite and the first one out) in each package."""
        p, k = self.p, self.p.cfg.cem_elites
        mu = torch.cat([prev_mu[:, 1:], torch.zeros_like(prev_mu[:, :1])], 1)
        sigma = torch.full_like(mu, p.cfg.init_sigma)
        lines = []
        for i in range(self.iters):
            acts = torch.clamp(mu[:, None] + sigma[:, None] * eps[i], -1, 1)
            rt = p._evaluate(self.state.params, self.state.norm, obs, z,
                             acts, None)
            rj = np.asarray(self.evaluate(jnp.asarray(obs[0].numpy()),
                                          jnp.asarray(z[0].numpy()),
                                          jnp.asarray(acts[0].numpy())))
            r = rt[0].numpy()
            ot, oj = np.argsort(-r, kind="stable"), np.argsort(-rj,
                                                              kind="stable")
            same = set(ot[:k]) == set(oj[:k])
            lines.append(
                f"    iter {i}: max |return diff| {np.abs(r - rj).max():.4g}, "
                f"elites {'equal' if same else 'differ'}, cut port "
                f"{r[ot[k - 1]]:.7g} / {r[ot[k]]:.7g}, jax "
                f"{rj[oj[k - 1]]:.7g} / {rj[oj[k]]:.7g}")
            new_mu, new_sigma = p._refit(acts, rt)
            mu = p.cfg.cem_alpha * mu + (1 - p.cfg.cem_alpha) * new_mu
            sigma = p.cfg.cem_alpha * sigma + (1 - p.cfg.cem_alpha) * new_sigma
        return lines

    def run(self, scale: float, n: int, steps: int) -> None:
        key = jax.random.key(100 + int(scale * 10))
        k_reset, k_run = jax.random.split(key)
        js = jax.vmap(lambda k: self.jenv.reset(k, 0))(
            jax.random.split(k_reset, n))
        js = dataclasses.replace(js, params=jax.tree.map(
            lambda x: jnp.full_like(x, scale), js.params))
        jh, jmu = jax_history(self.jm.cfg, n), self.jp.init_plan(n)
        th = batched_history(self.m.cfg, n, "cpu")
        worst = dict.fromkeys(("z", "action", "mu", "obs", "reward"), 0.0)
        ret, flips, t0 = np.zeros(n), 0, time.time()
        params, norm = self.state.params, self.state.norm
        for t, k in enumerate(jax.random.split(k_run, steps)):
            zj = self.ctx(jh)
            aj, muj = self.plan(js.obs, zj, k, jmu)
            zt = self.m.context_from_history(params, norm, th)
            eps = torch.from_numpy(self.eps(k, n))
            at, mut = self.p.plan(self.state, as_torch(js.obs), zt, gen=None,
                                  prev_mu=as_torch(jmu), noise=eps)
            _, tobs, trew, _ = self.env.step(
                env_states_to_torch(self.env, js), as_torch(aj),
                torch.Generator().manual_seed(0), 0)
            prev = js
            js, jobs, jrew, _ = self.step(js, aj)
            da = np.abs(at.numpy() - np.asarray(aj)).max(1)
            do = np.abs(tobs.numpy() - np.asarray(jobs)).max(1)
            for name, diff in (
                    ("z", np.abs(zt.numpy() - np.asarray(zj))),
                    ("action", da),
                    ("mu", np.abs(mut.numpy() - np.asarray(muj))),
                    ("obs", do),
                    ("reward", np.abs(trew.numpy() - np.asarray(jrew)))):
                # initial: Vanilla's z has no columns
                worst[name] = max(worst[name], float(diff.max(initial=0.0)))
            for e in np.flatnonzero(da > FLAG):
                flips += 1
                print(f"  step {t} env {e}: action {da[e]:.4g} apart",
                      flush=True)
                for line in self.elite_cut(
                        as_torch(prev.obs)[e:e + 1], zt[e:e + 1],
                        as_torch(jmu)[e:e + 1], eps[:, e:e + 1]):
                    print(line, flush=True)
            for e in np.flatnonzero(do > FLAG):
                alone = self.step(jax.tree.map(lambda x: x[e:e + 1], prev),
                                  aj[e:e + 1])[1]
                i = int(np.argmax(np.abs(tobs[e].numpy()
                                         - np.asarray(jobs)[e])))
                print(f"  step {t} env {e}: obs {i} port {tobs[e, i]:.7g}, "
                      f"jax in the batch {np.asarray(jobs)[e, i]:.7g}, jax "
                      f"stepping this env alone {np.asarray(alone)[0, i]:.7g}",
                      flush=True)
            ret += np.asarray(jrew)
            jh = self.push(jh, prev.obs, jobs - prev.obs, aj)
            th = self.m.push_history(params, norm, th, as_torch(prev.obs),
                                     as_torch(jobs) - as_torch(prev.obs),
                                     as_torch(aj))
            jmu = muj
        print(f"scale {scale}: {steps} steps × {n} envs, largest differences "
              + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
              + f"; actions more than {FLAG} apart in {flips} of {steps * n} "
              f"env steps; JAX returns {np.round(ret, 1).tolist()} "
              f"({time.time() - t0:.0f} s)", flush=True)


class PPOLockstep:
    """The lockstep of a PPO + CaDM policy (``cross.is_ppo``): the JAX
    package drives its eval policy (the clipped deterministic mean of its
    trainer's ``_dist`` on concat(obs, z)); at every step the port acts on
    the same obs and JAX-pushed history, and steps the JAX env state with
    the JAX action. Beside the largest differences it sums, per env, the
    port's reward minus the JAX package's on the same states and actions:
    what the two physics give a whole episode apart, with the acting held
    equal."""

    def __init__(self, cell: str, trained_by: str):
        family, model, seed = cross.cell_kwargs(cell)
        params_np, norm_np, policy_np, _ = cross.read_npz(
            f"{cell}__{trained_by}")
        cfg = ExperimentConfig(**{**FAMILY_BASE[family],
                                  **MODEL_VARIANTS[model]},
                               seed=seed, eval_modes=(0, 1, 2))
        self.jenv, self.jm, _, jtr = cfg.build()
        js = JaxState(
            params=jax.tree.map(jnp.asarray, params_np), opt_state=None,
            norm=JaxNorm(**{k: jnp.asarray(v) for k, v in norm_np.items()}),
            updates=jnp.asarray(0, jnp.int32))
        jpolicy = jax.tree.map(jnp.asarray, policy_np)
        self.env, self.m, _, self.tr = cell_config(cell).build("cpu")
        params, norm = params_from_jax(params_np, NormStats(**norm_np), "cpu")
        self.state = DynamicsState(params, norm)
        self.policy = params_from_jax(policy_np, NormStats(**norm_np),
                                      "cpu")[0]
        self.ctx = jax.jit(lambda h: self.jm.context_from_history(
            js.params, js.norm, h))
        self.push = jax.jit(lambda h, o, d, a: self.jm.push_history(
            js.params, js.norm, h, o, d, a))
        self.act = jax.jit(lambda o, z: jnp.clip(jtr._dist(
            jpolicy, jnp.concatenate([o, z], axis=-1))[0], -1.0, 1.0))
        self.step = jax.jit(jax.vmap(lambda s, a: self.jenv.step(s, a, 0)))

    def run(self, scale: float, n: int, steps: int) -> None:
        key = jax.random.key(100 + int(scale * 10))
        js = jax.vmap(lambda k: self.jenv.reset(k, 0))(
            jax.random.split(jax.random.split(key)[0], n))
        js = dataclasses.replace(js, params=jax.tree.map(
            lambda x: jnp.full_like(x, scale), js.params))
        jh = jax_history(self.jm.cfg, n)
        worst = dict.fromkeys(("z", "action", "obs", "reward"), 0.0)
        ret, dret, first, t0 = np.zeros(n), np.zeros(n), None, time.time()
        for t in range(steps):
            zj = self.ctx(jh)
            aj = self.act(js.obs, zj)
            obs_z = self.tr._obs_z(self.state, as_torch(js.obs),
                                   hists_to_torch(jh))
            at = torch.clamp(self.tr._dist(self.policy, obs_z)[0], -1.0, 1.0)
            zt = obs_z[:, self.env.obs_dim:]
            _, tobs, trew, _ = self.env.step(
                env_states_to_torch(self.env, js), as_torch(aj),
                torch.Generator().manual_seed(0), 0)
            prev = js
            js, jobs, jrew, _ = self.step(js, aj)
            do = np.abs(tobs.numpy() - np.asarray(jobs)).max(1)
            for name, diff in (
                    ("z", np.abs(zt.numpy() - np.asarray(zj))),
                    ("action", np.abs(at.numpy() - np.asarray(aj))),
                    ("obs", do),
                    ("reward", np.abs(trew.numpy() - np.asarray(jrew)))):
                worst[name] = max(worst[name], float(diff.max()))
            for e in np.flatnonzero(do > FLAG):
                first = (t, e) if first is None else first
                alone = self.step(jax.tree.map(lambda x: x[e:e + 1], prev),
                                  aj[e:e + 1])[1]
                i = int(np.argmax(np.abs(tobs[e].numpy()
                                         - np.asarray(jobs)[e])))
                print(f"  step {t} env {e}: obs {i} port {tobs[e, i]:.7g}, "
                      f"jax in the batch {np.asarray(jobs)[e, i]:.7g}, jax "
                      f"stepping this env alone {np.asarray(alone)[0, i]:.7g}",
                      flush=True)
            ret += np.asarray(jrew)
            dret += trew.numpy() - np.asarray(jrew)
            jh = self.push(jh, prev.obs, jobs - prev.obs, aj)
        print(f"scale {scale}: {steps} steps × {n} envs, largest differences "
              + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
              + f"; first obs more than {FLAG} apart at (step, env) {first}; "
              f"port − JAX reward summed over the episode on the same states "
              f"and actions {np.round(dret, 4).tolist()}; JAX returns "
              f"{np.round(ret, 1).tolist()} ({time.time() - t0:.0f} s)",
              flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cell", default=cross.CELL)
    ap.add_argument("--trained-by", default="port", choices=["port", "jax"],
                    help="a PPO cell: whose policy (its npz)")
    ap.add_argument("--scales", type=float, nargs="*", default=[0.5])
    ap.add_argument("--n-envs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)
    lock = (PPOLockstep(args.cell, args.trained_by) if cross.is_ppo(args.cell)
            else Lockstep(args.cell))
    for scale in args.scales:
        lock.run(scale, args.n_envs, args.steps)


if __name__ == "__main__":
    main()
