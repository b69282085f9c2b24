"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (the decision is made inside the fixture, never at import). On a
machine with a card and nvcc run ``python -m pytest tests/test_torch_cuda.py``;
``chip_smoke.py`` runs the same checks at the main path's shapes.
"""
import numpy as np
import pytest
import torch

from cadm_tpu_torch.envs.rigid_base import ASSETS, load_system
from cadm_tpu_torch.ops import fk_kernel, pgs
from cadm_tpu_torch.physics.rigid import dynamics as rdyn
from chip_smoke import f32_constants, smooth_state

pytestmark = pytest.mark.cuda

# λ 1e-4 is the reference's PGS tolerance; K2 is held against its plain
# version run in float64 at the reference's fused-kernel tolerances (the
# kernel computes in double; see chip_smoke.py for why float32 cannot meet
# them on slim_humanoid)
LAM_ATOL, MINV_ATOL, VPRED_ATOL, FK_ATOL = 1e-4, 5e-5, 5e-4, 1e-5
FK_FIELDS = ("body_pos", "body_rot", "com", "inertia_w", "dof_axis",
             "dof_anchor", "omega", "v_com", "alpha0", "a_com0")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("nc", [16, 29])
@pytest.mark.parametrize("iters", [15, 6])
def test_pgs_kernel_matches_plain(dev, nc, iters):
    e, n = 301, 3 * nc  # a ragged env count (blocks hold 4 or 2 envs)
    g = torch.Generator(device=dev).manual_seed(nc + iters)
    G = torch.randn(e, n, n, generator=g, device=dev)
    A = G @ G.transpose(1, 2) / n + 0.5 * torch.eye(n, device=dev)
    b = torch.randn(e, n, generator=g, device=dev)
    vstar = torch.randn(e, nc, generator=g, device=dev).abs()
    actmu = torch.tensor([0.0, 0.5, 1.0], device=dev)[
        torch.randint(0, 3, (e, nc), generator=g, device=dev)]
    inactive = (actmu == 0).repeat_interleave(3, dim=1)
    lam0 = torch.randn(e, n, generator=g, device=dev).abs() * ~inactive
    before = pgs.launches
    lam = pgs.pgs_solve(A, b, vstar, actmu, lam0, iters=iters)
    assert pgs.launches == before + 1
    ref = pgs.pgs_solve_plain(A, b, vstar, actmu, lam0, iters)
    assert (lam - ref).abs().max().item() <= LAM_ATOL
    assert torch.all(lam[inactive] == 0)


@pytest.mark.parametrize("asset", ASSETS)
def test_full_dyn_kernel_matches_plain_float64(dev, asset):
    sys_ = load_system(asset)
    e = 257  # ragged against K2's blocks of 4 (nv ≤ 16) or 2 envs
    rng = np.random.RandomState(0)
    qpos = sys_.default_qpos() + rng.uniform(-0.1, 0.1, (e, sys_.nq))
    for j in range(sys_.nj):
        if sys_.jnt_type[j] == 0:
            a = int(sys_.jnt_qposadr[j]) + 3
            qpos[:, a: a + 4] /= np.linalg.norm(qpos[:, a: a + 4], axis=-1,
                                                keepdims=True)
    am = np.ones((e, sys_.nu))
    am[::7, 0] = 0.0
    args = [torch.tensor(x, dtype=torch.float32, device=dev) for x in (
        qpos, rng.uniform(-1, 1, (e, sys_.nv)), rng.uniform(-1, 1, (e, sys_.nu)),
        rng.uniform(0.8, 1.2, e), rng.uniform(0.8, 1.2, e), am)]
    fkv, minv, vpred = fk_kernel.full_dyn(sys_, *args)
    fkv_r, minv_r, vpred_r = fk_kernel.full_dyn_plain(
        sys_, *(a.double() for a in args))
    assert (minv.double() - minv_r).abs().max().item() <= MINV_ATOL
    assert (vpred.double() - vpred_r).abs().max().item() <= VPRED_ATOL
    for name in FK_FIELDS:
        err = (getattr(fkv, name).double() - getattr(fkv_r, name)).abs().max()
        assert err.item() <= FK_ATOL, name


@pytest.mark.parametrize("asset", ASSETS)
def test_fk_vel_kernel_matches_plain_float64(dev, asset):
    """K3 (the FK-velocity walk alone) against its plain version in float64;
    its fields are the first part of K2's row, so they equal K2's."""
    sys_ = load_system(asset)
    e = 257  # ragged against K3's blocks of 8 or 4 envs
    rng = np.random.RandomState(2)
    qpos = sys_.default_qpos() + rng.uniform(-0.1, 0.1, (e, sys_.nq))
    for j in range(sys_.nj):
        if sys_.jnt_type[j] == 0:
            a = int(sys_.jnt_qposadr[j]) + 3
            qpos[:, a: a + 4] /= np.linalg.norm(qpos[:, a: a + 4], axis=-1,
                                                keepdims=True)
    qpos, qvel = (torch.tensor(x, dtype=torch.float32, device=dev)
                  for x in (qpos, rng.uniform(-1, 1, (e, sys_.nv))))
    before = fk_kernel.fk_vel_launches
    fkv = fk_kernel.fk_vel(sys_, qpos, qvel)
    assert fk_kernel.fk_vel_launches == before + 1
    ref = fk_kernel.fk_vel_plain(sys_, qpos.double(), qvel.double())
    for name in FK_FIELDS:
        err = (getattr(fkv, name).double() - getattr(ref, name)).abs().max()
        assert err.item() <= FK_ATOL, name
    ones = torch.ones(e, device=dev)
    rows = fk_kernel.launch(sys_, qpos, qvel, torch.zeros(e, sys_.nu, device=dev),
                            ones, ones, torch.ones(e, sys_.nu, device=dev))
    assert torch.equal(rows[:, :fk_kernel.fk_width(sys_)],
                       fk_kernel.launch_fk_vel(sys_, qpos, qvel))


@pytest.mark.parametrize("asset", ASSETS)
@pytest.mark.parametrize("e", [1, 5, 67, 257, 65536])
def test_fk_vel_kernel_ragged_env_counts(dev, asset, e):
    """K3 at env counts that leave a block part full (and at 65,536 envs)
    against its plain version run in float64 on the constants the kernel's
    table holds (float32)."""
    sys_ = load_system(asset)
    qpos, qvel = (torch.tensor(x, dtype=torch.float32, device=dev) for x in
                  smooth_state(sys_, np.random.RandomState(e), e)[:2])
    before = fk_kernel.fk_vel_launches
    fkv = fk_kernel.fk_vel(sys_, qpos, qvel)
    assert fk_kernel.fk_vel_launches == before + 1
    ref = fk_kernel.fk_vel_plain(f32_constants(sys_), qpos.double(),
                                 qvel.double())
    for name in FK_FIELDS:
        err = (getattr(fkv, name).double() - getattr(ref, name)).abs().max()
        assert err.item() <= FK_ATOL, name


def pgs_problem(dev, e, nc, seed):
    """Random SPD systems with a mix of inactive contacts (μ = 0), λ0 zero
    on the inactive ones."""
    n = 3 * nc
    g = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn(e, n, n, generator=g, device=dev)
    A = G @ G.transpose(1, 2) / n + 0.5 * torch.eye(n, device=dev)
    b = torch.randn(e, n, generator=g, device=dev)
    vstar = torch.randn(e, nc, generator=g, device=dev).abs()
    actmu = torch.tensor([0.0, 0.5, 1.0], device=dev)[
        torch.randint(0, 3, (e, nc), generator=g, device=dev)]
    inactive = (actmu == 0).repeat_interleave(3, dim=1)
    lam0 = torch.randn(e, n, generator=g, device=dev).abs() * ~inactive
    return A, b, vstar, actmu, lam0


def assert_pgs_matches_plain(A, b, vstar, actmu, lam0, iters):
    before = pgs.launches
    lam = pgs.pgs_solve(A, b, vstar, actmu, lam0, iters=iters)
    assert pgs.launches == before + 1
    ref = pgs.pgs_solve_plain(A, b, vstar, actmu, lam0, iters)
    assert (lam - ref).abs().max().item() <= LAM_ATOL
    assert torch.all(lam[(actmu <= 0).repeat_interleave(3, dim=1)] == 0)


# nc 4, 16 and 29 run 16 lanes per env (4 envs a block), 40 runs 32 (2 a
# block); the env counts leave a ragged last block
@pytest.mark.parametrize("nc", [4, 16, 29, 40])
@pytest.mark.parametrize("e", [1, 5, 9, 67])
def test_pgs_kernel_ragged_env_counts(dev, nc, e):
    assert_pgs_matches_plain(*pgs_problem(dev, e, nc, seed=e * nc), iters=6)


@pytest.mark.parametrize("nc", [16, 29])
@pytest.mark.parametrize("iters", [1, 6, 15])
@pytest.mark.parametrize("case", ["none_active", "all_active",
                                  "inactive_nonzero_lam0"])
def test_pgs_kernel_active_set_edges(dev, case, iters, nc):
    """Envs with na = 0 and na = nc, and a nonzero λ0 on an inactive
    contact (the first sweep then runs over every contact)."""
    e = 37
    A, b, vstar, actmu, lam0 = pgs_problem(dev, e, nc, seed=nc + iters)
    if case == "none_active":
        actmu[::2] = 0.0
        lam0[::2] = 0.0
    elif case == "all_active":
        actmu[::2] = 0.7
        lam0[::2] = torch.rand(lam0[::2].shape, device=dev)
    else:
        lam0[:, :] = torch.rand(lam0.shape, device=dev)  # also on inactive
        actmu[3] = 0.0  # one env with na = 0 but a nonzero λ0
    assert_pgs_matches_plain(A, b, vstar, actmu, lam0, iters)


def test_pgs_kernel_pool_rounds(dev):
    """At 16 × 2048 envs the launch shrinks each block's pool to one env's
    worst case, so a block's envs solve in turns."""
    assert_pgs_matches_plain(*pgs_problem(dev, 16 * 2048, 16, seed=3),
                             iters=15)


@pytest.mark.parametrize("asset", ASSETS)
def test_full_dyn_rows_hold_rotations_and_inertias(dev, asset):
    """K2's body_rot and inertia_w fields, read from the raw rows, against
    the plain version run in float64."""
    sys_ = load_system(asset)
    e = 131
    rng = np.random.RandomState(5)
    qpos = sys_.default_qpos() + rng.uniform(-0.3, 0.3, (e, sys_.nq))
    for j in range(sys_.nj):
        if sys_.jnt_type[j] == 0:
            a = int(sys_.jnt_qposadr[j]) + 3
            qpos[:, a: a + 4] /= np.linalg.norm(qpos[:, a: a + 4], axis=-1,
                                                keepdims=True)
    args = [torch.tensor(x, dtype=torch.float32, device=dev) for x in (
        qpos, rng.uniform(-1, 1, (e, sys_.nv)), rng.uniform(-1, 1, (e, sys_.nu)),
        rng.uniform(0.8, 1.2, e), rng.uniform(0.8, 1.2, e),
        np.ones((e, sys_.nu)))]
    rows = fk_kernel.launch(sys_, *args)
    ref = fk_kernel.full_dyn_plain(sys_, *(a.double() for a in args))[0]
    layout, width = fk_kernel.row_layout(sys_)
    assert rows.shape == (e, width)
    for name in ("body_rot", "inertia_w"):
        off, nb, comps = layout[name]
        got = rows[:, off: off + nb * comps].view(e, nb, 3, 3).double()
        err = (got - getattr(ref, name)).abs().max().item()
        assert err <= FK_ATOL, name


@pytest.mark.parametrize("asset", ["half_cheetah", "slim_humanoid"])
def test_full_dyn_on_the_card_is_one_kernel(dev, asset):
    """A CUDA full_dyn call runs one kernel and no other device op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys_ = load_system(asset)
    e = 64
    args = [torch.zeros(e, sys_.nq, device=dev) + torch.tensor(
                sys_.default_qpos(), dtype=torch.float32, device=dev),
            torch.zeros(e, sys_.nv, device=dev), torch.zeros(e, sys_.nu, device=dev),
            torch.ones(e, device=dev), torch.ones(e, device=dev),
            torch.ones(e, sys_.nu, device=dev)]
    fk_kernel.full_dyn(sys_, *args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fk_kernel.full_dyn(sys_, *args)
        torch.cuda.synchronize()
    ops = [(ev.key, ev.count) for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA]
    assert len(ops) == 1 and "full_dyn_kernel" in ops[0][0] \
        and ops[0][1] == 1, ops


def test_step_n_on_the_card_matches_the_cpu(dev):
    """Both kernels on the physics path, against the plain versions on CPU."""
    sys_ = load_system("half_cheetah")
    rng = np.random.RandomState(1)
    qpos = sys_.default_qpos() + rng.uniform(-0.1, 0.1, (64, sys_.nq))
    qpos[:, 1] -= np.linspace(0.0, 0.3, 64)  # some envs in ground contact
    host = [torch.tensor(x, dtype=torch.float32) for x in (
        qpos, rng.uniform(-1, 1, (64, sys_.nv)), rng.uniform(-1, 1, (64, sys_.nu)))]
    params = rdyn.RigidParams.default(sys_, 64)
    before = (pgs.launches, fk_kernel.launches)
    q_d, v_d = rdyn.step_n(sys_, rdyn.RigidParams.default(sys_, 64, dev),
                           *(x.to(dev) for x in host), 5)
    assert (pgs.launches - before[0], fk_kernel.launches - before[1]) == (5, 5)
    q_h, v_h = rdyn.step_n(sys_, params, *host, 5)
    np.testing.assert_allclose(q_d.cpu().numpy(), q_h.numpy(), atol=1e-5)
    np.testing.assert_allclose(v_d.cpu().numpy(), v_h.numpy(), atol=1e-4)


def test_full_dyn_with_a_crippled_leg_act_mask(dev):
    """CrippleAnt's per-env mask: zeroing a leg's actuators in the mask is
    bit for bit zeroing their controls, and within tolerance of the plain
    version run in float64."""
    from cadm_tpu_torch.envs.ant import LEG_ACTUATORS

    sys_ = load_system("ant")
    e = 131
    rng = np.random.RandomState(6)
    qpos = sys_.default_qpos() + rng.uniform(-0.1, 0.1, (e, sys_.nq))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=-1, keepdims=True)
    mask = np.ones((e, sys_.nu))
    for i in range(e):
        mask[i, LEG_ACTUATORS[i % 4]] = 0.0
    ctrl = rng.uniform(-1, 1, (e, sys_.nu))
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    q, v, ms, ds = f(qpos), f(rng.uniform(-1, 1, (e, sys_.nv))), f(
        np.ones(e)), f(np.ones(e))
    masked = fk_kernel.launch(sys_, q, v, f(ctrl), ms, ds, f(mask))
    zeroed = fk_kernel.launch(sys_, q, v, f(ctrl * mask), ms, ds,
                              f(np.ones_like(mask)))
    assert torch.equal(masked, zeroed)
    _, minv, vpred = fk_kernel.full_dyn(sys_, q, v, f(ctrl), ms, ds, f(mask))
    _, minv_r, vpred_r = fk_kernel.full_dyn_plain(
        sys_, *(x.double() for x in (q, v, f(ctrl), ms, ds, f(mask))))
    assert (minv.double() - minv_r).abs().max().item() <= MINV_ATOL
    assert (vpred.double() - vpred_r).abs().max().item() <= VPRED_ATOL


@pytest.mark.parametrize("name", ["hopper", "ant", "slim_humanoid"])
def test_pgs_kernel_on_captured_family_contacts(dev, name):
    """K1 on a family's own contact inputs: the cold and first warm solve of
    the control step after 10 random-action steps, against the plain
    version; the env step launches each kernel frame_skip times."""
    from cadm_tpu_torch.envs import make

    env = make(name, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    states = env.reset(gen, 256)

    def act():
        return 2 * torch.rand(256, env.act_dim, generator=gen, device=dev) - 1

    for _ in range(10):
        states = env.step(states, act(), gen)[0]
    captured, solve = [], rdyn.pgs_solve

    def keep(A, b, vstar, actmu, lam0, *, iters):
        captured.append((A.clone(), b.clone(), vstar.clone(), actmu.clone(),
                         lam0.clone(), iters))
        return solve(A, b, vstar, actmu, lam0, iters=iters)

    before = (pgs.launches, fk_kernel.launches)
    rdyn.pgs_solve = keep
    try:
        env.step(states, act(), gen)
    finally:
        rdyn.pgs_solve = solve
    assert (pgs.launches - before[0], fk_kernel.launches - before[1]) == (
        env.frame_skip, env.frame_skip)
    assert [c[-1] for c in captured] == [15] + [6] * (env.frame_skip - 1)
    assert sum(int((c[3] > 0).sum()) for c in captured[:2]) > 0
    for A, b, vstar, actmu, lam0, iters in captured[:2]:
        assert_pgs_matches_plain(A, b, vstar, actmu, lam0, iters)


GRAPH_TOY = dict(hidden=(16, 16), n_envs=8, eval_envs=4, n_candidates=16,
                 plan_horizon=5, cem_iters=2, cem_elites=4, warm_start=True,
                 steps_per_itr=6, env_horizon=4, buffer_capacity=32)


@pytest.mark.parametrize("preset,override", [
    ("halfcheetah_cadm_cem", {}),
    ("cripple_ant_cadm_ensemble_cem", dict(ensemble_eval="assign")),
    ("halfcheetah_cadm_cem", dict(model="grbal")),
])
def test_step_graph_replays_equal_the_op_by_op_steps(dev, preset, override):
    """A planned collect through two auto-resets and an eval episode,
    captured and replayed, against the same trainer op by op from the same
    weights and generator state (chip_smoke.py phase 15 at toy width):
    bit for bit or within GRAPH_RTOL, and K1/K2 launched frame_skip × (the
    control steps + the graph's warm-up steps)."""
    import dataclasses

    from chip_smoke import graph_compare
    from cadm_tpu_torch.cli.presets import PRESETS
    from cadm_tpu_torch.core.types import tree_map
    from cadm_tpu_torch.train import step_graph
    from cadm_tpu_torch.train.mb_trainer import MBTrainer

    cfg = dataclasses.replace(PRESETS[preset], **{**GRAPH_TOY, **override})
    env, model, planner, graphed = cfg.build(dev)
    eager = MBTrainer(env, model, planner, graphed.cfg, graph=False)
    assert graphed.graphs is not None and eager.graphs is None
    gen = torch.Generator(device=dev).manual_seed(0)
    states, hists, buf, dyn = eager.init(gen)
    states, hists, buf, _ = eager._collect(gen, states, hists, buf, dyn, True)
    start, runs = gen.get_state(), []
    for trainer in (eager, graphed):
        gen.set_state(start)
        before = (pgs.launches, fk_kernel.launches, step_graph.warmup_steps)
        out = trainer._collect(gen, *tree_map(torch.clone, (states, hists,
                                                            buf)), dyn, False)
        ret = trainer.evaluate(dyn, 1, gen)
        torch.cuda.synchronize()
        steps = cfg.steps_per_itr + env.horizon + (
            step_graph.warmup_steps - before[2])
        assert (pgs.launches - before[0], fk_kernel.launches - before[1]) \
            == (env.frame_skip * steps,) * 2
        runs.append((out, ret, gen.get_state()))
    (eo, er, eg), (go, gr, gg) = runs
    graph_compare(f"toy {preset} {override}", [
        ("collect", go, eo), ("eval returns", gr, er),
        ("generator state", gg, eg)])
    assert sorted(k[:3] for k in graphed.graphs.graphs) == [
        ("collect", cfg.n_envs, 0), ("eval", cfg.eval_envs, 1)]


def test_a_replay_adds_its_recorded_launches(dev):
    """Capture counts no launch; each replay adds frame_skip K1 and K2
    launches, and the warm-up's eager launches count as they run."""
    import dataclasses

    from cadm_tpu_torch.cli.presets import PRESETS
    from cadm_tpu_torch.core.types import batched_history
    from cadm_tpu_torch.train import step_graph

    cfg = dataclasses.replace(PRESETS["halfcheetah_cadm_cem"], **GRAPH_TOY)
    env, model, _, trainer = cfg.build(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    dyn = model.init_state(gen)
    carry = (env.reset(gen, 4), batched_history(model.cfg, 4, dev),
             trainer.planner.init_plan(4, dev))
    graph = trainer.graphs.load("eval", 0, dyn, carry, gen)
    before = (pgs.launches, step_graph.warmup_steps)
    graph()   # warm-up, capture, one replay
    warm = step_graph.warmup_steps - before[1]
    assert warm == step_graph.WARMUP_STEPS
    assert pgs.launches - before[0] == env.frame_skip * (warm + 1)
    assert graph.launches == {"pgs": env.frame_skip,
                              "full_dyn": env.frame_skip, "fk_vel": 0}
    for k in range(2, 5):
        graph()
        assert pgs.launches - before[0] == env.frame_skip * (warm + k)


@pytest.mark.parametrize("source", ["random", "actions", "policy"])
def test_sampler_replays_equal_the_op_by_op_rollout(dev, source):
    """The Sampler's rollout through auto-resets, each step a replay of the
    graph captured for the call, against ``Sampler(graph=False)`` from the
    same generator state (chip_smoke.py phase 17 at toy width), two calls
    each with the policy's weight tensor rebound between them: paths and
    generator state bit for bit or within GRAPH_RTOL, so no call replays
    the weights an earlier call captured; K1/K2 launched frame_skip × (the
    steps + the call's warm-up steps); the second call leaves no device
    memory held."""
    from chip_smoke import graph_compare
    from cadm_tpu_torch import envs
    from cadm_tpu_torch.core.rng import rand
    from cadm_tpu_torch.train import step_graph
    from cadm_tpu_torch.train.sampler import Sampler

    env = envs.make("half_cheetah", device=dev, horizon=5)
    n, steps = 8, 12
    g = torch.Generator(device=dev).manual_seed(1)
    actions = 2 * torch.rand(2, steps, n, env.act_dim, device=dev,
                             generator=g) - 1
    weights = torch.randn(2, env.obs_dim, env.act_dim, device=dev,
                          generator=g)

    class Policy:
        w = None

        def __call__(self, obs, hists, g):
            return torch.tanh(obs @ self.w + hists.dobs.sum((1, 2))[:, None]
                              + rand(g, obs.shape[0], env.act_dim))

    runs = []
    for graph in (False, True):
        sampler = Sampler(env, n, history_k=3, graph=graph)
        assert sampler.graph == graph
        gen = torch.Generator(device=dev).manual_seed(0)
        policy = Policy()
        for call in range(2):
            policy.w = weights[call].clone()  # rebound, not written in place
            kw = {"random": dict(random=True),
                  "actions": dict(actions=actions[call]),
                  "policy": dict(policy=policy)}[source]
            before = (pgs.launches, fk_kernel.launches,
                      step_graph.warmup_steps, torch.cuda.memory_allocated())
            paths = sampler.obtain_samples(gen, steps, **kw)
            torch.cuda.synchronize()
            if call:  # the call's graph and buffers are gone
                assert torch.cuda.memory_allocated() - before[3] <= 2 ** 20
            warm = step_graph.warmup_steps - before[2]
            assert warm == (step_graph.WARMUP_STEPS if graph else 0)
            assert (pgs.launches - before[0], fk_kernel.launches - before[1]) \
                == (env.frame_skip * (steps + warm),) * 2
            runs.append((paths, gen.get_state()))
    for call in range(2):
        (ep, eg), (gp, gg) = runs[call], runs[2 + call]
        assert ep["dones"].sum() == 2 * n
        graph_compare(f"sampler {source} call {call}", [
            ("paths", {k: torch.from_numpy(v) for k, v in gp.items()},
             {k: torch.from_numpy(v) for k, v in ep.items()}),
            ("generator state", gg, eg)])


def test_a_dropped_graph_is_not_freed_inside_a_capture(dev):
    """A trainer holds its graphs in a reference cycle, so a dropped one
    is freed by the cyclic collector, whenever it runs; a CUDA graph
    destroyed while another is captured invalidates that capture.
    Here a dead cycle holds a captured graph and the next capture's body
    allocates enough to set the collector off: the capture must hold."""
    import gc

    from cadm_tpu_torch.train.step_graph import Graph, Graphs

    class Holder:
        pass

    gc.collect()   # the dead cycle below starts in the youngest generation
    dead = Holder()
    dead.cycle = dead
    dead.graph = Graph(Graphs(dev), lambda c: (c + 1, c * 2),
                       torch.zeros(4, device=dev), None)
    dead.graph()
    del dead

    def body(c):
        if torch.cuda.is_current_stream_capturing():
            junk = [[] for _ in range(100_000)]  # noqa: F841
        return c + 1, c * 2

    graph = Graph(Graphs(dev), body, torch.zeros(4, device=dev), None)
    for k in range(3):
        out = graph()
    torch.cuda.synchronize()
    assert graph.graph is not None
    # the warm-up's steps are undone; the third replay reads a carry of 2
    assert out.tolist() == [4.0] * 4
