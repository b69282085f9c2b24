"""The port runs without jax, flax, optax or mujoco (the card's machine has
none of them) and without the JAX package.

Runs in a subprocess because this suite's conftest imports jax: there the
four modules are blocked in ``sys.modules``, every module of
``cadm_tpu_torch`` is imported, the four Systems are loaded from their npz
files and the acting slice runs at toy width on the CPU.
"""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "flax", "optax", "mujoco"):
        sys.modules[name] = None  # any import of them raises ImportError

    import dataclasses, importlib, pkgutil
    import torch
    import cadm_tpu_torch

    for info in pkgutil.walk_packages(cadm_tpu_torch.__path__, "cadm_tpu_torch."):
        importlib.import_module(info.name)

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
    states, hists, dyn = trainer.init(gen)
    returns = trainer.evaluate(dyn, 1, gen)
    assert returns.shape == (4,) and torch.isfinite(returns).all(), returns

    if not torch.cuda.is_available():
        try:
            cfg.build("cuda")
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("build('cuda') ran without a card")

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "optax", "mujoco",
                                           "cadm_tpu") and sys.modules[m])
    assert not leaked, leaked
    print("OK")
""")


def test_port_imports_and_runs_without_jax_or_mujoco():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")
