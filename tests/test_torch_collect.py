"""The port's random-action collect against the JAX trainer's.

The JAX trainer's uniform actions are rebuilt from its keys
(``mb_trainer.py:188-191``) and handed to the port; both collect 6 steps of 4
HalfCheetah envs into a ring of 5 columns, with episodes ending at different
steps (set-up in torch_collect_common.py).
"""
import jax
import torch

from tests.torch_collect_common import E, STEPS, assert_collect_matches, setup


def test_random_collect_matches_jax():
    jtr, jargs, tr, args = setup()
    rng = jax.random.key(4)
    actions = torch.stack([
        torch.tensor(jax.device_get(jax.random.uniform(
            k, (E, 6), minval=-1.0, maxval=1.0)))
        for k in jax.random.split(rng, STEPS)])
    jout = jtr._collect_random(rng, *jargs)
    out = tr._collect(torch.Generator().manual_seed(0), *args,
                      random_actions=True, noise=actions)
    assert_collect_matches(jout, out)
    # the actions went into the ring in order (capacity 5: the first wrapped)
    buf = out[2]
    assert torch.equal(buf.act[:, (buf.ptr - 1) % 5], actions[-1])
