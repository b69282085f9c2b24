"""The port's planned collect against the JAX trainer's.

CEM with warm start plans through the same (JAX-initialized) CaDM weights and
context; the JAX planner's truncated-normal ε is rebuilt from the collect's
keys (``mb_trainer.py:232`` → ``mpc.py:plan`` → ``_plan_single``) and handed
to the port. Episodes end inside the collect, so the wipe of the context
window and of the warm-start plan on done shapes the later actions on both
sides (set-up in torch_collect_common.py).
"""
import jax
import torch

from tests.torch_collect_common import (
    STEPS,
    assert_collect_matches,
    jax_noise,
    setup,
)


def test_planned_collect_matches_jax():
    jtr, jargs, tr, args = setup()
    rng = jax.random.key(5)
    noise = torch.stack([jax_noise(k) for k in jax.random.split(rng, STEPS)])
    jout = jtr._collect_plan(rng, *jargs)
    out = tr._collect(torch.Generator().manual_seed(0), *args,
                      random_actions=False, noise=noise)
    assert_collect_matches(jout, out)
