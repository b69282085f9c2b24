"""Write the float64 reference of slim_humanoid's eval-scale parity test.

``tests/test_torch_env_humanoid.py`` holds the port's float32 ``step_phys``
at moderate and extreme scales to the JAX package's own step run in float64
(``jax.enable_x64``), on ``tests/torch_families_common.family_batch(
"slim_humanoid", 1, eval_range=True)``. At the (mass 1.8, damping 0.2)
corner the JAX package's float32 step is 1.33e-4 from its float64 one in
qvel (|qvel| ≈ 14), beyond the test's 1e-4, while the port's float32 step
is 4.8e-5 from it; compiling the float64 reference takes ≈ 70 s on the CPU,
so it is stored instead of recompiled in every test run.

    JAX_PLATFORMS=cpu python scripts/make_eval_scale_references.py

writes ``tests/data/slim_humanoid_eval_scales_x64.npz``: the batch's
inputs and qpos/qvel after 1 and 3 control steps.
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "data", "slim_humanoid_eval_scales_x64.npz")
STEPS = (1, 3)


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    from tests.torch_families_common import family_batch, jax_step_phys

    name = "slim_humanoid"
    qpos, qvel, ctrl, params = family_batch(name, 1, eval_range=True)
    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    out = {"qpos": qpos, "qvel": qvel, "ctrl": ctrl, "mass_scale": params[0],
           "damping_scale": params[1]}
    with jax.enable_x64(True):
        q, v = f64(qpos), f64(qvel)
        for step in range(1, max(STEPS) + 1):
            q, v = jax_step_phys(name, tuple(map(f64, params)), q, v,
                                 f64(ctrl))
            assert q.dtype == np.float64
            if step in STEPS:
                out[f"qpos_{step}"], out[f"qvel_{step}"] = q, v
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
