"""The trainers' control steps, and programs captured as CUDA graphs.

The reference compiles its planned collect (one ``lax.scan`` over time) and
each eval episode (one ``lax.scan`` over the horizon) with ``jax.jit``
(cadm_tpu/train/mb_trainer.py:118-143), so one control step (context →
plan, itself a scan inside a scan → env step → history push) is one XLA
program. Run op by op, the same step is some 8,500 kernel launches from the
host, and at the result matrix's 32 eval envs the host's launching, not the
card, sets its time. Here the step is captured once into a CUDA graph
(``torch.cuda.CUDAGraph``) per (kind, env count, mode, generator) and
replayed each control step: one launch from the host.

A graph reads and writes fixed addresses, so a ``StepGraph`` owns static
buffers: the carry (env states, histories, CEM warm-start plan), the
step's output, and (shared by all the graphs of a trainer) the weights and
norm statistics. The captured body computes the step from those buffers and
copies its results back into them, so a replay advances the carry in place.
What the caller keeps across steps it copies out first: the next replay
overwrites the output. The weights are copied in at every ``load``, which
the trainer calls at the start of every collect and eval, so a replay never
reads an earlier fit's weights.

Every random draw of the step comes from the generator the caller passes
(CEM's truncated normals, TS1's permutations, the auto-reset's draws). It is
registered with the graph (``register_generator_state``), so N replays draw
what N op-by-op steps draw and leave the generator in the same state.

Before its capture a graph runs ``WARMUP_STEPS`` steps on its capture
stream (first launches build the kernels, opt them in to shared memory and
fill caches of host constants, none of which a capture may do), from a copy
of the carry and with the generator's state saved and restored after, so
the warm-up moves neither the run's state nor its draws. The warm-up steps
of a control step's graph launch the kernels for real and are counted in
``warmup_steps``. A replay adds
the K1/K2 launches its capture recorded to the wrappers' counts
(``ops._build.add_replayed``). The graphs of a trainer share one memory
pool and one capture stream: they never run at once. A failed capture or
replay raises; nothing returns to the op-by-op step.

The machinery is general: a ``Graph`` runs any ``body(carry, *inputs) →
(carry, output)`` on static buffers, and ``train/fit_graph.py`` captures a
fit's updates with it on the same pool and stream. Which programs are
captured is the trainer's rule. On a CUDA device: every control step of the
MB trainer's collects (random and planned) and eval episodes, for every
model and planner (GrBAL's adaptation step, autograd included, captures
too); the PPO trainer's collect and eval steps (``train/ppo.py``); and, off
a mesh, each update and valid estimate of a fit, GAE and each PPO
minibatch step. On a mesh the steps keep their graphs (their gathers are
outside the step), while the fit and the PPO update run op by op: their
gathers and sums go through ``torch.distributed``, which a capture cannot
hold. The ``Sampler``'s rollout (``train/sampler.py``) captures its
control step as a ``Graph`` on each call. The CPU and ``graph=False`` keep
the op-by-op loop; a ``StepGraphs`` made with ``capture=False`` runs its
bodies on its static buffers without capturing (the CPU tests check the
bookkeeping that way).
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Dict, Optional

import torch

from cadm_tpu_torch.core.rng import EnvRows, rand
from cadm_tpu_torch.core.types import leading_dim, tree_map, tree_where
from cadm_tpu_torch.ops import _build

Tensor = torch.Tensor

# steps run on a capture stream before each capture (PyTorch's
# make_graphed_callables runs 3)
WARMUP_STEPS = 3
# control steps run as warm-up in this process (chip_smoke.py adds them to
# the steps whose kernel launches it expects)
warmup_steps = 0


@dataclasses.dataclass
class Transition:
    """One collect step's transition of every env, for the ring and the
    collect metrics."""

    actions: Tensor
    prev_obs: Tensor
    obs: Tensor
    reward: Tensor
    done: Tensor
    bad: Tensor
    ep_step: Tensor


def _plan(trainer, dyn, carry, g, noise=None):
    states, hists, plan_mu = carry
    z = trainer.model.context_from_history(dyn.params, dyn.norm, hists)
    return trainer.planner.plan(dyn, states.obs, z, g, plan_mu, noise=noise)


def _collect_transition(trainer, dyn, carry, actions, g):
    """Step the envs under ``actions`` → (carry, Transition). On done the env
    has auto-reset, so its context window and warm-start plan are wiped."""
    env, model = trainer.env, trainer.model
    states, hists, plan_mu = carry
    prev_obs, ep_step = states.obs, states.t
    states, obs, reward, done = env.step(states, actions, g)
    bad = env.bad_transition(prev_obs, obs)
    pushed = model.push_history(dyn.params, dyn.norm, hists, prev_obs,
                                obs - prev_obs, actions)
    plan_mu = torch.where(done[:, None, None], 0.0, plan_mu)
    hists = tree_where(done, tree_map(torch.zeros_like, pushed), pushed)
    return (states, hists, plan_mu), Transition(
        actions, prev_obs, obs, reward, done, bad, ep_step)


def random_step(trainer, dyn, carry, g, mode: int = 0, noise=None):
    """A collect step under uniform actions in [-1, 1] (``noise``: the
    actions)."""
    if noise is None:
        n = carry[2].shape[0]
        noise = 2.0 * rand(g, n, trainer.env.act_dim) - 1.0
    return _collect_transition(trainer, dyn, carry, noise, g)


def collect_step(trainer, dyn, carry, g, mode: int = 0, noise=None):
    """A collect step under the planner's actions (``noise``: its ε)."""
    actions, plan_mu = _plan(trainer, dyn, carry, g, noise)
    return _collect_transition(trainer, dyn, (*carry[:2], plan_mu), actions,
                               g)


def eval_step(trainer, dyn, carry, g, mode: int = 0, noise=None):
    """An eval step in ``mode`` → (carry, (reward, done)); the histories and
    plan carry on through an auto-reset, as in the reference's eval."""
    states, hists, _ = carry
    actions, plan_mu = _plan(trainer, dyn, carry, g, noise)
    prev_obs = states.obs
    states, obs, reward, done = trainer.env.step(states, actions, g, mode)
    hists = trainer.model.push_history(dyn.params, dyn.norm, hists, prev_obs,
                                       obs - prev_obs, actions)
    return (states, hists, plan_mu), (reward, done)


STEPS: Dict[str, Callable] = {"random": random_step, "collect": collect_step,
                              "eval": eval_step}


def _copy_into(dst, src) -> None:
    """Copy the tree ``src`` leafwise into the static tree ``dst``."""
    tree_map(Tensor.copy_, dst, src)


class Graphs:
    """One memory pool and one capture stream, shared by the graphs of a
    trainer (none, and no capture, with ``capture=False``). The graphs never
    run at once, and what one leaves for another lives in static buffers
    outside the pool. ``stream``: the capture stream (a new one if None);
    cuBLAS keeps a workspace for each stream it has run on."""

    def __init__(self, device, capture: bool = True,
                 stream: Optional[torch.cuda.Stream] = None):
        self.pool = self.stream = None
        if capture:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = stream or torch.cuda.Stream(device=device)


class Graph:
    """``body(carry, *inputs) → (carry, out)`` on static buffers, with the
    memory pool and capture stream of ``owner`` (a ``Graphs``): ``load`` a
    carry, call the object with the inputs (copied into static inputs) →
    the output, valid until the next call; ``carry_out`` the carry after.
    Where the owner captures, the first call warms up and captures the body
    and every call replays it; else every call runs the body.

    ``gen`` (a ``torch.Generator``, an ``EnvRows`` or None where the body
    draws nothing) is registered with the capture. ``env_steps``: the body
    is one env control step, so each warm-up step counts in
    ``warmup_steps``."""

    def __init__(self, owner: Graphs, body: Callable, carry, gen,
                 env_steps: bool = False):
        self.owner, self.body, self.gen = owner, body, gen
        self.env_steps = env_steps
        self.carry = tree_map(torch.clone, carry)
        self.inputs: tuple = ()
        self.out = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Optional[dict] = None  # K1/K2/K3 launches a replay runs

    def load(self, carry) -> None:
        _copy_into(self.carry, carry)

    def carry_out(self):
        return tree_map(torch.clone, self.carry)

    def _run(self) -> None:
        carry, out = self.body(self.carry, *self.inputs)
        if self.out is None:
            self.out = tree_map(torch.empty_like, out)
        # the output first: it may hold the carry's old leaves (prev_obs,
        # ep_step), and every new carry leaf is a new tensor
        _copy_into(self.out, out)
        _copy_into(self.carry, carry)

    def _capture(self) -> None:
        global warmup_steps
        gen = self.gen.gen if isinstance(self.gen, EnvRows) else self.gen
        carry = self.carry_out()
        rng = None if gen is None else gen.get_state()
        stream = self.owner.stream
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                self._run()
        torch.cuda.current_stream().wait_stream(stream)
        if self.env_steps:
            warmup_steps += WARMUP_STEPS
        if gen is not None:
            gen.set_state(rng)
        self.load(carry)
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        before = dict(_build.captured)
        # no cyclic garbage collection inside the capture: a dropped trainer
        # holds its graphs in a reference cycle, and destroying a CUDA graph
        # while another is captured invalidates that capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.owner.pool, stream=stream):
                self._run()
        finally:
            if collecting:
                gc.enable()
        self.launches = {k: n - before[k] for k, n in _build.captured.items()}
        self.graph = graph

    def __call__(self, *inputs):
        if inputs:
            if self.inputs:
                _copy_into(self.inputs, inputs)
            else:
                self.inputs = tree_map(torch.clone, inputs)
        if self.owner.stream is None:
            self._run()
            return self.out
        if self.graph is None:
            self._capture()
        self.graph.replay()
        _build.add_replayed(self.launches)
        return self.out

    def reset(self) -> None:
        """Drop the capture (its memory goes back to the pool)."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


class StepGraph(Graph):
    """One control step ``fn(trainer, weights, carry, gen, mode)`` (→
    (carry, output)) as a ``Graph`` whose trainer and static weights are
    those of ``owner`` (a ``StepGraphs``)."""

    def __init__(self, owner: "StepGraphs", fn: Callable, mode: int, carry,
                 gen):
        super().__init__(owner, lambda c: fn(owner.trainer, owner.weights, c,
                                             gen, mode),
                         carry, gen, env_steps=True)


class StepGraphs(Graphs):
    """A trainer's step graphs, one per (kind, env count, mode, generator),
    with one set of static weights, one memory pool and one capture stream
    (none, and no capture, with ``capture=False``). ``steps`` maps a kind
    to its step function (the MB trainer's ``STEPS`` by default)."""

    def __init__(self, trainer, capture: bool = True,
                 steps: Optional[Dict[str, Callable]] = None):
        super().__init__(trainer.env.device, capture)
        self.trainer = trainer
        self.steps = STEPS if steps is None else steps
        self.graphs: Dict[tuple, StepGraph] = {}
        self.weights = None

    def _load_weights(self, weights) -> None:
        if self.weights is None:
            self.weights = tree_map(torch.clone, weights)
        else:
            _copy_into(self.weights, weights)

    def load(self, kind: str, mode: int, weights, carry, gen) -> StepGraph:
        """The graph of a ``kind`` step in ``mode`` for ``carry``'s envs,
        loaded with ``weights`` (what the step function reads as its
        second argument: the MB trainer's ``DynamicsState`` of params and
        norm) and ``carry``."""
        self._load_weights(weights)
        key = (kind, leading_dim(carry), mode, gen)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = StepGraph(self, self.steps[kind], mode,
                                                 carry, gen)
        else:
            graph.load(carry)
        return graph


def stepper(trainer, steps: Dict[str, Callable],
            graphs: Optional[StepGraphs], kind: str, mode: int, weights, carry,
            g, noise: Optional[Tensor] = None):
    """(``step(t)``, ``final()``) of ``trainer``'s ``kind`` steps (``steps``
    maps a kind to its function) from ``carry``: ``step`` runs control step
    t and returns its output (valid until the next step), ``final`` gives
    the carry after the steps taken. With ``graphs`` each step is a replay
    of its graph; else the step runs op by op. ``noise`` (step t's actions
    or ε) is taken by the op-by-op step only."""
    if graphs is not None:
        if noise is not None:
            raise ValueError("noise is taken by the op-by-op step only "
                             f"({type(trainer).__name__}(graph=False))")
        graph = graphs.load(kind, mode, weights, carry, g)
        return (lambda t: graph()), graph.carry_out
    fn = steps[kind]
    box = [carry]

    def step(t):
        box[0], out = fn(trainer, weights, box[0], g, mode,
                         None if noise is None else noise[t])
        return out

    return step, lambda: box[0]
