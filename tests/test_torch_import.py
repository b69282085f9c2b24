"""The port runs without jax, flax, optax, orbax or mujoco (the card's
machine has none of them), without the JAX package and without the
reference's scripts.

Runs in a subprocess because this suite's conftest imports jax: there those
modules and ``cadm_tpu`` are blocked in ``sys.modules``, every module of
``cadm_tpu_torch`` is imported (the replay ring, the CLI, the logger, the
baselines, the checkpointer, the trajectory sink, the analytic envs, the
wrapper, the Sampler, the PPO trainer, the mesh, the result-matrix
runner and renderer and the snapshot analyses among them), the four
Systems are loaded from their npz files, the acting slice runs at toy
width on the CPU,
toy ReBAL and GrBAL runs train, checkpoint and resume, a bare config builds
the reference's default cartpole, and a toy PPO + CaDM run and a Sampler
run on the CPU.
"""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "flax", "optax", "orbax", "mujoco",
                 "cadm_tpu", "scripts"):
        sys.modules[name] = None  # any import of them raises ImportError

    import dataclasses, importlib, pkgutil
    import torch
    import cadm_tpu_torch

    names = {info.name for info in pkgutil.walk_packages(
        cadm_tpu_torch.__path__, "cadm_tpu_torch.")}
    assert {"cadm_tpu_torch.train.buffer", "cadm_tpu_torch.cli.run",
            "cadm_tpu_torch.utils.logger", "cadm_tpu_torch.envs.hopper",
            "cadm_tpu_torch.envs.ant", "cadm_tpu_torch.envs.slim_humanoid",
            "cadm_tpu_torch.models.grbal", "cadm_tpu_torch.planners.grbal_mpc",
            "cadm_tpu_torch.utils.checkpoint", "cadm_tpu_torch.utils.trajsink",
            "cadm_tpu_torch.utils.debug", "cadm_tpu_torch.utils.profiling",
            "cadm_tpu_torch.envs.cartpole", "cadm_tpu_torch.envs.pendulum",
            "cadm_tpu_torch.envs.wrappers", "cadm_tpu_torch.train.sampler",
            "cadm_tpu_torch.train.ppo", "cadm_tpu_torch.parallel.mesh",
            "cadm_tpu_torch.parallel.dryrun", "cadm_tpu_torch.core.rng",
            "cadm_tpu_torch.cli.matrix", "cadm_tpu_torch.cli.results",
            "cadm_tpu_torch.analysis.snapshot",
            "cadm_tpu_torch.analysis.probe_context",
            "cadm_tpu_torch.analysis.probe_hstep",
            "cadm_tpu_torch.analysis.probe_blowup",
            "cadm_tpu_torch.analysis.probe_dist",
            "cadm_tpu_torch.analysis.probe_epochs",
            "cadm_tpu_torch.analysis.probe_ranges",
            "cadm_tpu_torch.analysis.ab_ts1",
            } <= names, names
    for name in sorted(names):
        importlib.import_module(name)

    from cadm_tpu_torch.cli.presets import PRESETS
    from cadm_tpu_torch.envs.rigid_base import ASSETS, load_system

    sizes = {a: (load_system(a).nb, load_system(a).nv) for a in ASSETS}
    assert sizes == {"half_cheetah": (8, 9), "hopper": (5, 6), "ant": (14, 14),
                     "slim_humanoid": (14, 23)}, sizes

    cfg = dataclasses.replace(
        PRESETS["halfcheetah_cadm_cem"], hidden=(32, 32), n_candidates=16,
        plan_horizon=5, cem_iters=2, cem_elites=4, n_envs=4, eval_envs=4,
        env_horizon=3,
    )
    env, model, planner, trainer = cfg.build("cpu")
    gen = torch.Generator().manual_seed(0)
    states, hists, buffer, dyn = trainer.init(gen)
    returns = trainer.evaluate(dyn, 1, gen)
    assert returns.shape == (4,) and torch.isfinite(returns).all(), returns
    assert buffer.obs.shape == (4, cfg.buffer_capacity, 17)

    # the PE-TS ensemble on CrippleAnt, symmetry-augmented fit included
    cfg = dataclasses.replace(
        PRESETS["cripple_ant_cadm_ensemble_cem"], hidden=(16, 16),
        n_candidates=8, plan_horizon=3, cem_iters=1, cem_elites=2, n_envs=2,
        eval_envs=2, env_horizon=3, buffer_capacity=12, batch_size=4,
        steps_per_itr=6, n_itr=1, max_epochs=1, symmetry_aug=True,
    )
    _, _, _, trainer = cfg.build("cpu")
    dyn, history = trainer.train(gen)
    assert len(history) == 1 and dyn.params["fwd"][0]["w"].shape[0] == 5

    # toy ReBAL and GrBAL: a checkpointed iteration each, then a resume
    import tempfile
    from cadm_tpu_torch.utils.checkpoint import Checkpointer

    for model in ("rnn", "grbal"):
        toy = dataclasses.replace(
            PRESETS["halfcheetah_cadm_cem"], model=model, hidden=(8, 8, 8),
            n_candidates=4, plan_horizon=2, cem_iters=1, cem_elites=2,
            n_envs=2, eval_envs=1, eval_modes=(0,), env_horizon=2,
            buffer_capacity=8, batch_size=4, steps_per_itr=2, n_itr=2,
            max_epochs=1, eval_every=2)
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = Checkpointer(tmp)
            _, _, _, trainer = dataclasses.replace(toy, n_itr=1).build("cpu")
            trainer.train(gen, checkpointer=ckpt)
            _, _, _, trainer = toy.build("cpu")
            dyn, history = trainer.train(gen, resume=ckpt.restore())
        assert [r["itr"] for r in history] == [1], history
        assert torch.isfinite(torch.tensor(history[0]["eval/return_mode0"]))

    # the default config (cartpole), PPO + CaDM on pendulum, the Sampler
    from cadm_tpu_torch.cli.presets import ExperimentConfig
    from cadm_tpu_torch.envs.wrappers import NormalizedEnv
    from cadm_tpu_torch.train.sampler import ModelSampleProcessor, Sampler

    env, _, _, _ = ExperimentConfig().build("cpu")
    assert env.obs_dim == 5, env
    ppo = ExperimentConfig(
        trainer="ppo", env="pendulum", model="cadm", normalize_env=True,
        hidden=(8, 8), policy_hidden=(8, 8), n_envs=2, eval_envs=2,
        eval_modes=(0,), rollout_len=4, env_horizon=3, ppo_epochs=1,
        ppo_minibatches=2, model_updates_per_itr=2, batch_size=4,
        buffer_capacity=8, n_itr=1)
    env, _, _, trainer = ppo.build("cpu")
    assert isinstance(env, NormalizedEnv)
    ppo_state, _, history = trainer.train(gen)
    assert ppo_state.updates == 2 and len(history) == 1, history
    paths = Sampler(env, 2).obtain_samples(gen, 4, random=True)
    assert ModelSampleProcessor().process_samples(paths)[
        "observations"].shape == (8, 3)

    if not torch.cuda.is_available():
        try:
            cfg.build("cuda")
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("build('cuda') ran without a card")

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                           "mujoco", "cadm_tpu")
                    and sys.modules[m])
    assert not leaked, leaked
    print("OK")
""")


def test_port_imports_and_runs_without_jax_or_mujoco():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")
