"""Shared set-up of the snapshot-analysis parity tests
(tests/test_torch_analysis_*.py): the reference's cells built as its
scripts build them, an untrained snapshot in both packages (as
tests/test_probe_hstep.py makes one), and the JAX env states and histories
carried over to the port's classes."""
import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cadm_tpu.cli.presets import ExperimentConfig as JaxExperimentConfig  # noqa: E402
from scripts.run_matrix import FAMILY_BASE, MODEL_VARIANTS  # noqa: E402
from cadm_tpu_torch.analysis.snapshot import cell_config, dyn_state_from_jax  # noqa: E402
from cadm_tpu_torch.core.types import EnvState, History  # noqa: E402
from cadm_tpu_torch.utils.checkpoint import to_plain  # noqa: E402


def jax_cell(cell, **overrides):
    """(env, dyn, planner, trainer) of the reference, as its probe scripts
    build a cell (the family's base, the variant over it, the overrides)."""
    family, model, seed = cell.split("__")
    kwargs = {**FAMILY_BASE[family], **MODEL_VARIANTS[model], **overrides}
    return JaxExperimentConfig(**kwargs, seed=int(seed[1:])).build()


def snapshots(cell, directory, **norm):
    """An untrained snapshot of ``cell`` (``dyn.init_state(key(0))``) in
    both packages' formats, ``<cell>.pkl`` (the reference's numpy pytree)
    and ``<cell>.pt`` (the port's plain dicts), under ``directory`` →
    (the JAX state, the port's state). ``norm`` sets fields of the
    normalization (identity otherwise) to constants, e.g. so that
    predictions drift."""
    _, dyn, _, _ = jax_cell(cell)
    jstate = dyn.init_state(jax.random.key(0))
    jstate = jstate.replace(norm=jstate.norm.replace(**{
        k: jnp.full_like(getattr(jstate.norm, k), v) for k, v in norm.items()}))
    snap = jax.tree.map(np.asarray, jstate)
    with open(os.path.join(directory, cell + ".pkl"), "wb") as f:
        pickle.dump(snap, f)
    state = dyn_state_from_jax(snap, "cpu")
    torch.save(to_plain(state), os.path.join(directory, cell + ".pt"))
    return jstate, state


def port_snapshot(cell, directory, seed=0):
    """An untrained port snapshot ``<directory>/<cell>.pt`` made by the port
    alone."""
    _, dyn, _, _ = cell_config(cell).build("cpu")
    state = dyn.init_state(torch.Generator().manual_seed(seed))
    torch.save(to_plain(state), os.path.join(directory, cell + ".pt"))
    return state


def t(x):
    return torch.from_numpy(np.array(x))


def dataclass_to_torch(template, jtree):
    """The port dataclass ``type(template)`` with the JAX dataclass's
    fields of the same names."""
    return type(template)(**{f.name: t(getattr(jtree, f.name))
                             for f in dataclasses.fields(template)})


def env_states_to_torch(env, jstates):
    """The port's EnvState of a batch of JAX env states (its per-env keys
    dropped), in ``env``'s phys and params classes."""
    n = int(np.asarray(jstates.t).shape[0])
    tmpl = env.reset(torch.Generator().manual_seed(0), n)
    return EnvState(phys=dataclass_to_torch(tmpl.phys, jstates.phys),
                    obs=t(jstates.obs),
                    params=dataclass_to_torch(tmpl.params, jstates.params),
                    t=t(jstates.t), done=t(jstates.done))


def hists_to_torch(jh):
    return History(*(t(getattr(jh, f)) for f in
                     ("obs", "dobs", "act", "valid", "rnn_h")))


def jax_reset(env, keys, mode=0):
    """The reference env's reset states of ``keys``."""
    return jax.vmap(lambda k: env.reset(k, mode))(keys)


def jax_random_start(trainer, dyn_state, key):
    """The scripts' start states: ``trainer.init(key)`` then a random
    collect from the same key."""
    env_states, hists, buffer, _ = trainer.init(key)
    env_states, hists, _, _ = trainer._collect_random(
        key, env_states, hists, buffer, dyn_state)
    return env_states, hists
