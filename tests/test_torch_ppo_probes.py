"""The two C3 probes end to end at a toy width on the CPU, both sides:
``scripts/probe_first_itr.py`` (k iterations, seeds per side, the compare)
and ``scripts/probe_common_state.py`` (a state trained by each package,
each piece run on it by both, the verdict), on pendulum PPO + CaDM (the
cheetah's JAX collect alone compiles for about a minute).

The power check: the common-state fit must tell the packages apart when
the port's model learning rate is doubled, and must not when the configs
are equal. Every JAX program is compiled once and shared by the runs.
"""
import json
import os
import shutil

import numpy as np
import pytest

from scripts import probe_common_state as cs
from scripts import probe_first_itr as fi

FAMILY, ITRS, SEEDS, REPS = "pendulum", 2, 2, 16
WIDTH = ["n_envs=4", "rollout_len=16", "buffer_capacity=20", "hidden=16,16,",
         "policy_hidden=16,16,", "model_updates_per_itr=10", "batch_size=8",
         "ppo_epochs=2", "ppo_minibatches=2", "z_dim=4", "history_k=4",
         "future_m=3"]
LR = 1e-3   # ExperimentConfig's model lr, which the power check doubles
CELL = f"{FAMILY}__ppo_cadm"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every side of both probes, into one temporary directory; the
    common-state port side twice (equal configs on both states, the
    doubled lr on the port-trained one)."""
    root = tmp_path_factory.mktemp("probes")
    first, states = str(root / "first_itr"), str(root / "state")
    common = {k: str(root / k) for k in ("equal", "lr2")}
    base = ["--family", FAMILY, "--width", *WIDTH]
    programs = fi.main(["--side", "jax", "--itrs", str(ITRS), "--seeds",
                        str(SEEDS), "--out-dir", first, *base])
    fi.main(["--side", "port", "--device", "cpu", "--itrs", str(ITRS),
             "--seeds", str(SEEDS), "--out-dir", first, *base])
    fi.main(["--side", "compare", "--itrs", str(ITRS), "--out-dir", first,
             "--family", FAMILY])
    cs_args = ["--itr", str(ITRS), "--reps", str(REPS), "--state-dir",
               states, *base]
    cs.main(["--side", "port-state", "--device", "cpu", "--out-dir",
             common["equal"], *cs_args])
    cs.main(["--side", "jax-state", "--out-dir", common["equal"], *cs_args],
            programs)
    cs.main(["--side", "jax", "--out-dir", common["equal"], *cs_args],
            programs)
    os.makedirs(common["lr2"])
    shutil.copy(os.path.join(common["equal"], f"{CELL}.k{ITRS}.jax.json"),
                common["lr2"])
    for name, extra in (("equal", []),
                        ("lr2", ["--port-width", f"lr={2 * LR}", "--states",
                                 "port"])):
        cs.main(["--side", "port", "--device", "cpu", "--out-dir",
                 common[name], *cs_args, *extra])
        cs.main(["--side", "verdict", "--device", "cpu", "--out-dir",
                 common[name], *cs_args])
    return first, states, common


def load(path):
    with open(path) as f:
        return json.load(f)


def test_first_itr_rows_per_seed_and_iteration(runs):
    """Each side has a row per (seed, iteration) with the 8 metrics, the
    policy's mean log_std, the norm's mean obs std and the ring's size;
    the compare gives each (metric, iteration) a verdict and names the
    first parting iteration or "none by k"."""
    first, _, _ = runs
    for side in ("port", "jax"):
        out = load(os.path.join(first, f"{CELL}.k{ITRS}.{side}.json"))
        assert out["itrs"] == ITRS
        assert sorted((r["seed"], r["itr"]) for r in out["rows"]) == [
            (s, i) for s in range(SEEDS) for i in range(ITRS)]
        for r in out["rows"]:
            assert set(fi.METRICS + fi.STATE_METRICS) <= set(r)
            assert all(np.isfinite(r[m]) for m in fi.METRICS)
            assert r["ring_size"] == min(16 * (r["itr"] + 1), 20)
    cmp = load(os.path.join(first, f"{CELL}.k{ITRS}.compare.json"))
    assert cmp["seeds"] == {"port": [0, 1], "jax": [0, 1]}
    assert set(cmp["metrics"]) == set(fi.METRICS + fi.STATE_METRICS)
    assert set(cmp["pooled"]) == set(fi.METRICS + fi.STATE_METRICS) - {
        "ring_size"}
    for per in cmp["metrics"].values():
        assert [v["itr"] for v in per] == list(range(ITRS))
    parted = cmp["first_parting_itr"]
    assert parted == f"none by {ITRS}" or isinstance(parted, int)


def test_first_parting_needs_three_consecutive_misses():
    assert fi.first_parting([True, False, False, True, False]) is None
    assert fi.first_parting([True, False, False, False, True]) == 1


def test_k1_keeps_its_file_names():
    assert fi.side_path("d", "c", 1, "port") == os.path.join("d",
                                                             "c.port.json")
    assert fi.side_path("d", "c", 20, "jax", 10) == os.path.join(
        "d", "c.k20.jax.from10.json")


def test_state_files_cross_both_ways(runs):
    """Both trainers' states hold the same fields and shapes, ring
    included, and the ring's ``next_obs`` comes back bit for bit from its
    compressed form."""
    _, states, _ = runs
    files = {t: os.path.join(states, f"{CELL}.{t}.k{ITRS}.npz")
             for t in cs.TRAINERS}
    loaded = {t: cs.load_state(p) for t, p in files.items()}
    flat = {t: cs.flatten(s) for t, (s, _) in loaded.items()}
    assert sorted(flat["port"]) == sorted(flat["jax"])
    for k in flat["port"]:
        assert flat["port"][k].shape == flat["jax"][k].shape, k
    for t, (state, meta) in loaded.items():
        assert meta["trainer"] == t and meta["itr"] == ITRS
        ring = state["ring"]
        assert int(ring["size"]) == 20 and int(ring["ptr"]) == 8  # wrapped
        path = os.path.join(states, f"again.{t}.npz")
        cs.save_state(path, state, meta)
        again, _ = cs.load_state(path)
        np.testing.assert_array_equal(again["ring"]["next_obs"],
                                      ring["next_obs"])


def test_equal_configs_agree_on_the_fit(runs):
    """Equal configs: the common-state fit's judged losses agree on both
    states."""
    _, _, common = runs
    out = load(os.path.join(common["equal"], f"{CELL}.k{ITRS}.verdict.json"))
    assert out["reps"] == {"port": REPS, "jax": REPS}
    assert sorted(out["verdicts"]) == ["jax", "port"]
    for trainer, per in out["verdicts"].items():
        assert sorted(per) == sorted(cs.PIECES)
        for m in ("train_loss", "valid_loss"):
            v = per["fit"][m]
            assert v["agree"], (trainer, m, v)
            assert v["detectable"] > v["bound"] > 0
        assert {"kl", "d_log_std", "clip_frac", "surrogate"} <= set(
            per["ppo"])
        assert {"reward_per_env", "episodes", "mean_abs_act"} == set(
            per["collect"])


def test_doubled_model_lr_on_one_side_differs(runs):
    """The port's model lr doubled: the judged fit differs (the
    port-trained state)."""
    _, _, common = runs
    out = load(os.path.join(common["lr2"], f"{CELL}.k{ITRS}.verdict.json"))
    assert out["port_width"] == [f"lr={2 * LR}"]
    assert sorted(out["verdicts"]) == ["port"]
    fit = out["verdicts"]["port"]["fit"]
    assert not fit["train_loss"]["agree"] and not fit["valid_loss"][
        "agree"], fit


@pytest.mark.parametrize("family", ["pendulum", "half_cheetah"])
def test_state_converters_round_trip(family):
    """A port trainer's state through ``state_to_numpy`` and back through
    ``env_state_from_jax``, ``history_from_jax``, ``buffer_from_jax`` and
    ``dynamics_state_from_jax``: every tensor and count bit for bit."""
    import torch

    from cadm_tpu_torch.utils import convert

    tr = fi.port_trainer(family, "ppo_cadm", 0, "cpu", WIDTH)
    states, hists, buf, _, dyn = tr.init(torch.Generator().manual_seed(0))
    buf.ptr, buf.size = 5, 17
    dyn.opt_state.count.fill_(3)
    back = (convert.env_state_from_jax(convert.state_to_numpy(states), "cpu",
                                       type(states.phys), type(states.params)),
            convert.history_from_jax(convert.state_to_numpy(hists), "cpu"),
            convert.buffer_from_jax(convert.state_to_numpy(buf), "cpu"),
            convert.dynamics_state_from_jax(convert.state_to_numpy(dyn),
                                            "cpu"))
    for ours, theirs in zip((states, hists, buf, dyn), back):
        assert type(ours) is type(theirs)
        a, b = (cs.flatten(convert.state_to_numpy(x)) for x in (ours, theirs))
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (back[2].ptr, back[2].size) == (5, 17)
    assert int(back[3].opt_state.count) == 3
