"""A trainer's fit programs, op by op or as captured CUDA graphs.

The reference compiles each fit with ``jax.jit`` (the MB trainer's ``_fit``,
cadm_tpu/train/mb_trainer.py:118-143; PPO's ``_ppo_update`` and
``_fit_model``, cadm_tpu/train/ppo.py:76-81): the updates are one XLA
program. Run op by op, one ``Dynamics.update`` (draw → gather → loss →
``autograd.grad`` → clip + Adam) is some 300 kernel launches from the host
for about 1 ms of device work. Here an update is captured once into a CUDA
graph (``step_graph.Graph``) and replayed for every update of a fit.

A fit is a state (parameters, Adam moments and count, norm statistics, a
host count of updates) advanced by a ``step(state, *inputs) → (state,
output)`` and read by a ``valid(state, *inputs) → output``. ``EagerFit``
runs both op by op; ``GraphFit`` keeps the state in static buffers that
each replay of the step's graph updates in place, and captures ``valid``
as a graph of its own that reads them. Both give tensors of their own from
``update`` and ``valid`` and the state after from ``final``, so a caller
holds no buffer that a later replay overwrites; ``final`` clones the
static state and adds the updates taken to its host count.

A graph bakes in the host numbers its body reads: the ring's write column
and fill (``ReplayBuffer.ptr``/``size``) and with them the draws' upper
bounds, fixed within one fit and grown between fits. So ``FitGraphs``
keys each fit by what it baked in (``ring_key``) and captures again where
that changed: a warm-up of ``step_graph.WARMUP_STEPS`` updates on the
static state (restored after, with the generator's state) and a capture,
once a fit. The draws are the op-by-op fit's, from the generator
registered with the capture, so a graphed fit draws what the op-by-op fit
draws.

Which fits are graphed is the trainer's rule: on a CUDA device, off a
mesh. On a mesh the fit's batch gather and gradient sums go through
``torch.distributed``, which a capture cannot hold, so the fit runs op by
op there; the CPU and ``graph=False`` run op by op too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from cadm_tpu_torch.core.types import tree_map
from cadm_tpu_torch.train.step_graph import Graph, Graphs


def _own(tree):
    return tree_map(torch.clone, tree)


class EagerFit:
    """A fit op by op: ``update(*inputs)`` takes one step and returns its
    output, ``valid(*inputs)`` reads the current state, ``final()`` is the
    state after the steps taken."""

    def __init__(self, state, step: Callable, valid: Optional[Callable]):
        self.state, self.step, self.valid_fn = state, step, valid

    def update(self, *inputs):
        self.state, out = self.step(self.state, *inputs)
        return out

    def valid(self, *inputs):
        return self.valid_fn(self.state, *inputs)

    def final(self):
        return self.state


class GraphFit:
    """The same fit on static buffers: ``step`` and ``valid`` each a
    ``Graph`` (captured at its first call where the owner captures), their
    outputs cloned before they are returned. ``key``: what the captures
    baked in (``FitGraphs``)."""

    def __init__(self, owner: Graphs, key, state, gen, step: Callable,
                 valid: Optional[Callable]):
        self.key = key
        self.steps = Graph(owner, step, state, gen)
        self.valids = None if valid is None else Graph(
            owner, lambda carry, *inputs: (carry, valid(self.steps.carry,
                                                        *inputs)), (), None)
        self.updates, self.taken = state.updates, 0

    def load(self, state) -> None:
        self.steps.load(state)
        self.updates, self.taken = state.updates, 0

    def update(self, *inputs):
        out = _own(self.steps(*inputs))
        self.taken += 1
        return out

    def valid(self, *inputs):
        return _own(self.valids(*inputs))

    def final(self):
        return dataclasses.replace(self.steps.carry_out(),
                                   updates=self.updates + self.taken)

    def reset(self) -> None:
        for graph in (self.steps, self.valids):
            if graph is not None:
                graph.reset()


class FitGraphs:
    """A trainer's fits by name, each a ``GraphFit`` on the memory pool and
    capture stream of ``owner`` (the trainer's ``StepGraphs``, or a
    ``Graphs`` of its own), captured again where its key changed."""

    def __init__(self, owner: Graphs):
        self.owner = owner
        self.fits: Dict[str, GraphFit] = {}

    def load(self, name: str, key, state, gen, step: Callable,
             valid: Optional[Callable] = None) -> GraphFit:
        fit = self.fits.get(name)
        if fit is not None and fit.key == key:
            fit.load(state)
            return fit
        if fit is not None:
            fit.reset()
        fit = self.fits[name] = GraphFit(self.owner, key, state, gen, step,
                                         valid)
        return fit


def fitter(graphs: Optional[FitGraphs], name: str, key, state, gen,
           step: Callable, valid: Optional[Callable] = None):
    """The fit ``name`` of ``state`` by ``step`` and ``valid``: a
    ``GraphFit`` of ``graphs`` keyed by ``key``, or with no ``graphs`` an
    ``EagerFit``. ``gen``: the generator the step draws from (None: it
    draws nothing)."""
    if graphs is None:
        return EagerFit(state, step, valid)
    return graphs.load(name, key, state, gen, step, valid)


def ring_key(buffer) -> tuple:
    """What a fit's capture bakes in of the ring ``buffer``: its storage
    and its write column and fill."""
    return (tuple(getattr(buffer, f).data_ptr() for f in
                  ("obs", "act", "next_obs", "done", "ep_step", "bad")),
            buffer.ptr, buffer.size)
