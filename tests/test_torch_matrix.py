"""The port's result-matrix runner and renderer (``cadm_tpu_torch/cli/
matrix.py``, ``cli/results.py``) against the reference's scripts
(``scripts/run_matrix.py``, ``scripts/make_results.py``): every cell's
config, the runner's attempt/crash/SIGTERM bookkeeping (``run_cell``
monkeypatched, as tests/test_matrix_runner.py does for the reference), a
toy MB and a toy PPO cell trained on the CPU by both runners (the same JSON
keys, bar the port's ``card``, and the same history columns), the config of
each cell committed under ``results/torch/raw/``, the rendered table rows on
``results/raw/``, the fit trace (``--fit-trace``) of the reference's records
and the loss-variant tag.
"""
import dataclasses
import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import scripts.make_results as mr  # noqa: E402
import scripts.run_matrix as rm  # noqa: E402
from cadm_tpu.cli.presets import ExperimentConfig as JaxExperimentConfig  # noqa: E402
from cadm_tpu.models.dynamics import LOSS_VARIANT as JAX_LOSS_VARIANT  # noqa: E402
from cadm_tpu_torch.analysis.snapshot import read_ppo_snapshot  # noqa: E402
from cadm_tpu_torch.cli import matrix, results  # noqa: E402
from cadm_tpu_torch.models.dynamics import LOSS_VARIANT  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the libtpu row-fault workaround the port does not carry
DROPPED = "max_parallel_rollouts"


def _without_dropped(table):
    return {k: {f: v for f, v in fields.items() if f != DROPPED}
            for k, fields in table.items()}


# ------------------------------------------------------------ (i) configs --
def test_the_tables_are_the_references_without_the_row_budget():
    assert _without_dropped(rm.FAMILY_BASE) == matrix.FAMILY_BASE
    assert _without_dropped(rm.MODEL_VARIANTS) == matrix.MODEL_VARIANTS
    assert matrix.DEFAULT_FAMILIES == rm.DEFAULT_FAMILIES
    assert matrix.cell_name("hopper", "ppo_cadm", 1) == rm.cell_name(
        "hopper", "ppo_cadm", 1) == "hopper__ppo_cadm__s1"


@pytest.mark.parametrize("family", sorted(rm.FAMILY_BASE))
def test_every_cell_configures_as_the_reference(family):
    """All of the family's cells, as the reference's run_cell builds them
    (its probed row budget only sets the dropped field)."""
    for model in rm.MODEL_VARIANTS:
        for seed in (0, 1):
            ref = dataclasses.asdict(JaxExperimentConfig(
                **{**rm.FAMILY_BASE[family], **rm.MODEL_VARIANTS[model]},
                seed=seed, eval_modes=(0, 1, 2)))
            ref.pop(DROPPED)
            ours = dataclasses.asdict(matrix.cell_config(family, model, seed))
            assert ours == ref, (family, model, seed)


# -------------------------------------------------------- (ii) bookkeeping --
ARGV = ["--families", "cartpole", "--models", "vanilla", "--seeds", "0",
        "--device", "cpu"]


@pytest.fixture()
def raw_dir(tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    monkeypatch.setattr(matrix, "RESULTS_DIR", str(raw))
    monkeypatch.setattr(matrix, "CKPT_DIR", str(tmp_path / "ckpt"))
    return raw


def _cell(raw, ext):
    return raw / f"cartpole__vanilla__s0{ext}"


def _raises(exc):
    def run_cell(f, m, s, device):
        raise exc
    return run_cell


def test_success_clears_attempts(raw_dir, monkeypatch):
    monkeypatch.setattr(
        matrix, "run_cell",
        lambda f, m, s, device: ({"family": f, "model": m, "seed": s,
                                  "wall_clock_s": 1.0,
                                  "history": [{"eval/return_mode0": 1.0,
                                               "eval/return_mode1": 1.0,
                                               "eval/return_mode2": 1.0}]},
                                 {"w": torch.ones(2)}))
    matrix.main(ARGV)
    assert json.loads(_cell(raw_dir, ".json").read_text())["seed"] == 0
    assert not _cell(raw_dir, ".attempts").exists()
    assert not _cell(raw_dir, ".json.tmp").exists()
    snap = torch.load(os.path.join(matrix.CKPT_DIR, "cartpole__vanilla__s0.pt"),
                      weights_only=True)
    assert torch.equal(snap["w"], torch.ones(2))


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    *([torch.AcceleratorError("device-side fault")]
      if hasattr(torch, "AcceleratorError") else []),
], ids=lambda e: type(e).__name__)
def test_cuda_error_exits_17_and_counts_attempt(raw_dir, monkeypatch, exc):
    monkeypatch.setattr(matrix, "run_cell", _raises(exc))
    with pytest.raises(SystemExit) as e:
        matrix.main(ARGV)
    assert e.value.code == 17
    assert _cell(raw_dir, ".attempts").read_text() == "1"
    assert not _cell(raw_dir, ".crashed").exists()
    assert not _cell(raw_dir, ".failed").exists()


def test_three_starts_without_finish_marks_crashed(raw_dir, monkeypatch):
    monkeypatch.setattr(matrix, "run_cell",
                        _raises(RuntimeError("CUDA error: unspecified launch "
                                             "failure")))
    for expected in ("1", "2", "3"):
        with pytest.raises(SystemExit):
            matrix.main(ARGV)
        assert _cell(raw_dir, ".attempts").read_text() == expected
    # the 4th pass sees 3 starts, marks .crashed and skips the cell
    calls = []
    monkeypatch.setattr(matrix, "run_cell", lambda *a: calls.append(a))
    matrix.main(ARGV)
    assert _cell(raw_dir, ".crashed").exists()
    assert not _cell(raw_dir, ".attempts").exists()
    matrix.main(ARGV)
    assert calls == []


def test_hang_kill_counts_like_crash(raw_dir, monkeypatch):
    """A kill from outside leaves no exception, only a stale .attempts:
    three such starts also end in .crashed."""
    monkeypatch.setattr(matrix, "run_cell", _raises(KeyboardInterrupt()))
    for _ in range(3):
        with pytest.raises(KeyboardInterrupt):
            matrix.main(ARGV)
    matrix.main(ARGV)
    assert _cell(raw_dir, ".crashed").exists()


def test_python_failure_writes_failed_marker_and_clears_attempts(
        raw_dir, monkeypatch):
    monkeypatch.setattr(matrix, "run_cell",
                        _raises(ValueError("shape mismatch")))
    matrix.main(ARGV)  # an ordinary failure goes on with the sweep
    assert "shape mismatch" in _cell(raw_dir, ".failed").read_text()
    assert not _cell(raw_dir, ".attempts").exists()
    calls = []
    monkeypatch.setattr(matrix, "run_cell", lambda *a: calls.append(a))
    matrix.main(ARGV)
    assert calls == []


def test_sigterm_restores_attempt_counter(raw_dir, monkeypatch):
    ap = _cell(raw_dir, ".attempts")

    def dies_by_sigterm(f, m, s, device):
        matrix._on_sigterm(None, None)

    monkeypatch.setattr(matrix, "run_cell", dies_by_sigterm)
    with pytest.raises(SystemExit) as e:
        matrix.main(ARGV)
    assert e.value.code == 143
    assert not ap.exists()  # the pre-start count was 0
    ap.write_text("1")
    with pytest.raises(SystemExit):
        matrix.main(ARGV)
    assert ap.read_text() == "1"


def test_main_defaults_to_the_card_and_raises_without_one(raw_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        matrix.main(ARGV[:-2])
    assert not raw_dir.exists() or not os.listdir(raw_dir)


# ------------------------------------------------- (iii) toy cells, CPU --
TOY_FAMILY = {
    "cartpole": dict(hidden=(16, 16), n_envs=2, eval_envs=2, n_candidates=8,
                     plan_horizon=3, steps_per_itr=10, n_itr=2,
                     buffer_capacity=20, batch_size=8, max_epochs=2,
                     env_horizon=5),
    "pendulum": dict(hidden=(16, 16), env_horizon=5),
}
TOY_VARIANT = {
    "vanilla": {},
    "ppo_cadm": dict(n_envs=2, eval_envs=2, rollout_len=8, n_itr=2,
                     model_updates_per_itr=2, batch_size=4,
                     buffer_capacity=16, ppo_epochs=1, ppo_minibatches=2,
                     policy_hidden=(8, 8)),
}


@pytest.mark.parametrize("family, model", [("cartpole", "vanilla"),
                                           ("pendulum", "ppo_cadm")])
def test_a_toy_cell_records_what_the_reference_records(
        family, model, raw_dir, monkeypatch, tmp_path):
    for mod in (rm, matrix):
        monkeypatch.setattr(mod, "FAMILY_BASE", {
            **mod.FAMILY_BASE,
            family: {**mod.FAMILY_BASE[family], **TOY_FAMILY[family]}})
        monkeypatch.setattr(mod, "MODEL_VARIANTS", {
            **mod.MODEL_VARIANTS,
            model: {**mod.MODEL_VARIANTS[model], **TOY_VARIANT[model]}})
    monkeypatch.setattr(rm, "PROBE_PATH", str(tmp_path / "no_probe.json"))
    ref, _ = rm.run_cell(family, model, 0)

    matrix.main(["--families", family, "--models", model, "--seeds", "0",
                 "--device", "cpu"])
    name = matrix.cell_name(family, model, 0)
    with open(raw_dir / f"{name}.json") as f:
        ours = json.load(f)
    assert set(ours) == set(ref) | {"card"}
    assert ours["card"] == "cpu" and ours["loss_variant"] == JAX_LOSS_VARIANT
    assert [list(row) for row in ours["history"]] == [
        list(row) for row in ref["history"]]
    ref_config = json.loads(json.dumps(ref["config"]))
    ref_config.pop(DROPPED)
    assert ours["config"] == ref_config
    snap = torch.load(os.path.join(matrix.CKPT_DIR, name + ".pt"),
                      weights_only=True)
    assert set(snap) >= {"params", "norm"}
    if model.startswith("ppo"):
        # the PPO state beside the model, as the cross-evaluation reads it
        assert set(snap) >= {"params", "norm", "ppo"}
        assert set(snap["ppo"]) == {"params", "opt_state", "updates"}
        assert snap["ppo"]["updates"] == 2 * 1 * 2
        ppo = read_ppo_snapshot(os.path.join(matrix.CKPT_DIR, name + ".pt"),
                                "cpu")
        assert torch.equal(ppo.params["log_std"],
                           snap["ppo"]["params"]["log_std"])
    else:
        assert "ppo" not in snap


# ---------------------------------------------- (iii b) the committed cells --
TORCH_RAW = os.path.join(ROOT, "results", "torch", "raw")
COMMITTED = sorted(f[:-len(".json")] for f in os.listdir(TORCH_RAW)
                   if f.endswith(".json"))


@pytest.mark.parametrize("name", COMMITTED)
def test_a_committed_cell_records_its_matrix_config(name):
    """Each cell the card wrote under ``results/torch/raw/`` holds, for its
    ``<family>__<model>__s<seed>`` name, every field ``cell_config`` sets,
    and was trained on a card."""
    family, model, seed = name.split("__")
    with open(os.path.join(TORCH_RAW, name + ".json")) as f:
        cell = json.load(f)
    seed = int(seed[1:])
    assert (cell["family"], cell["model"], cell["seed"]) == (
        family, model, seed)
    config = dataclasses.asdict(matrix.cell_config(family, model, seed))
    assert cell["config"] == json.loads(json.dumps(config))
    assert cell["card"] and cell["card"] != "cpu"


# ------------------------------------------------------ (iv) the renderer --
def _rows(lines):
    return [line for line in lines if line.startswith("|")]


def test_the_rendered_rows_are_the_references(tmp_path, monkeypatch):
    out = tmp_path / "RESULTS.md"
    monkeypatch.setattr(mr, "OUT", str(out))
    monkeypatch.setattr(sys, "argv", ["make_results.py"])
    mr.main()
    ours = results.render(os.path.join(ROOT, "results", "raw"))
    assert _rows(ours) == _rows(out.read_text().split("\n"))
    assert len(_rows(ours)) > 40


def test_a_cuda_error_is_the_skip_reason(tmp_path):
    (tmp_path / "hopper__cadm__s0.failed").write_text(
        "Traceback ...\ntorch.AcceleratorError: CUDA error: an illegal "
        "memory access was encountered\n")
    (tmp_path / "hopper__ppo__s0.failed").write_text("ValueError: shape\n")
    (tmp_path / "hopper__vanilla__s0.failed").write_text(
        "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate\n")
    out = tmp_path / "out.md"
    results.main(["--raw", str(tmp_path), "--out", str(out)])
    rows = _rows(out.read_text().split("\n"))
    assert "| hopper | Vanilla + CaDM | — | — | — | — | 0 | skip: CUDA error |" \
        in rows
    assert "| hopper | PPO | — | — | — | — | 0 | skip: error |" in rows
    assert "| hopper | Vanilla | — | — | — | — | 0 | skip: OOM |" in rows
    assert "| cartpole | Vanilla | — | — | — | — | 0 | skip: not yet run |" \
        in rows


def _write_cell(d, seed, ret):
    d.mkdir(exist_ok=True)
    (d / f"cartpole__vanilla__s{seed}.json").write_text(json.dumps({
        "family": "cartpole", "model": "vanilla", "seed": seed,
        "wall_clock_s": 60.0, "history": [
            {f"eval/return_mode{m}": ret + m for m in range(3)}]}))


@pytest.mark.parametrize("ours, mark", [(13.0, ""), (15.0, " out"),
                                        (17.0, " out ×2")])
def test_compare_marks_a_row_outside_the_references_spread(tmp_path, ours,
                                                           mark):
    _write_cell(tmp_path / "ref", 0, 10.0)
    _write_cell(tmp_path / "ref", 1, 14.0)  # mean 12 ± 2 on train
    _write_cell(tmp_path / "ours", 0, ours)
    rows = results.compare(str(tmp_path / "ours"), str(tmp_path / "ref"))
    assert rows[2] == (f"| cartpole | Vanilla | {ours:.1f} / 12.0 ± 2.0{mark} | "
                       f"{ours + 1:.1f} / 13.0 ± 2.0{mark} | "
                       f"{ours + 2:.1f} / 14.0 ± 2.0{mark} | — | 1 / 2 |")
    assert len(rows) == 3


def test_the_last_k_evals_are_an_added_view(tmp_path, capsys):
    """``--last-k``: each run's evals per mode as the mean of its last k
    (NaN evals skipped) beside its last two, and each reference seed's last
    k; the comparison above it keeps the last two."""
    def cell(d, seed, train):
        d.mkdir(exist_ok=True)
        history = [{"itr": i, "eval/return_mode0": v, "eval/return_mode1":
                    v / 2, "eval/return_mode2": float("nan")}
                   for i, v in enumerate(train)]
        history.insert(2, {"itr": 9})    # an iteration without evals
        (d / f"half_cheetah__vanilla__s{seed}.json").write_text(json.dumps({
            "family": "half_cheetah", "model": "vanilla", "seed": seed,
            "wall_clock_s": 60.0, "history": history}))

    cell(tmp_path / "ours", 0, [100.0, 900.0, 500.0, 100.0, 300.0])
    cell(tmp_path / "ref", 0, [0.0, 1000.0, 3000.0, 4000.0, 6000.0])
    cell(tmp_path / "ref", 1, [2000.0, 2000.0, 2000.0, 2000.0, 2000.0])
    rows = results.last_k_table(str(tmp_path / "ours"),
                                str(tmp_path / "ref"), k=3)
    assert rows[0] == ("| cell | last 2 evals | last 3 evals | reference "
                       "seeds, last 3 |")
    assert rows[2] == ("| half_cheetah__vanilla__s0 | 200.0 / 100.0 / — | "
                       "300.0 / 150.0 / — | s0 4333.3 / 2166.7 / —; "
                       "s1 2000.0 / 1000.0 / — |")
    assert len(rows) == 3
    results.main(["--raw", str(tmp_path / "ours"), "--out",
                  str(tmp_path / "out.md"), "--against",
                  str(tmp_path / "ref"), "--last-k", "3"])
    out = capsys.readouterr().out.split("\n")
    assert out.index(rows[2]) > out.index(
        "| half_cheetah | Vanilla | 200.0 / 3500.0 ± 1500.0 out ×2 | "
        "100.0 / 1750.0 ± 750.0 out ×2 | — | — | 1 / 2 |")


# ---------------------------------------------------- (iv b) the fit trace --
JAX_RAW = os.path.join(ROOT, "results", "raw")


@pytest.mark.parametrize("name, want", [
    # the shared-trunk ensemble's degradation, and the detached head's hold
    ("half_cheetah__pets_cadm__s0", (0.0313, 0.0660, 0.117, 3.50)),
    ("half_cheetah__pets_cadm_dv__s0", (0.0139, 0.0082, 0.016, 5.50)),
])
def test_the_fit_trace_of_a_reference_record(name, want):
    with open(os.path.join(JAX_RAW, name + ".json")) as f:
        trace = results.fit_trace(json.load(f))
    assert [round(v, 4) for v in trace[:2]] == list(want[:2])
    assert round(trace[2], 3) == want[2] and trace[3] == want[3]


def test_the_fit_trace_names_a_record_without_the_column(tmp_path):
    for name in ("half_cheetah__cadm__s0", "half_cheetah__pets_cadm__s0"):
        with open(os.path.join(JAX_RAW, name + ".json")) as f:
            (tmp_path / (name + ".json")).write_text(f.read())
    with open(os.path.join(JAX_RAW, "half_cheetah__cadm__s0.json")) as f:
        assert results.fit_trace(json.load(f)) is None
    rows = results.fit_trace_table(str(tmp_path), JAX_RAW)
    assert rows[2] == ("| half_cheetah__cadm__s0 | skip: no "
                       "fit/valid_fwd_mse_after column | s0 no column; s1 "
                       "0.0165 → 0.0131, max 0.018, epochs 3.88 |")
    assert rows[3].startswith("| half_cheetah__pets_cadm__s0 | 0.0313 → "
                              "0.0660, max 0.117, epochs 3.50 | s0 0.0313")
    assert len(rows) == 4
    out = tmp_path / "out.md"
    results.main(["--raw", str(tmp_path), "--out", str(out), "--fit-trace"])
    assert not out.exists()


def test_the_fit_trace_reads_grbal_on_its_valid_loss(tmp_path):
    """GrBAL's records carry the forward-MSE column as NaN at every
    iteration (its loss reports none): the trace reads the valid loss, and
    says so, for the cell and its reference seeds alike."""
    name = "half_cheetah__grbal__s1"
    with open(os.path.join(JAX_RAW, name + ".json")) as f:
        record = json.load(f)
    (tmp_path / (name + ".json")).write_text(json.dumps(record))
    assert all(h[results.FIT_MSE] != h[results.FIT_MSE]
               for h in record["history"])
    trace = results.fit_trace(record)
    assert [round(v, 4) for v in trace[:2]] == [0.2685, 0.1853]
    assert round(trace[2], 3) == 0.301 and trace[3] == 4.125
    assert trace[4] == results.FIT_LOSS
    rows = results.fit_trace_table(str(tmp_path), JAX_RAW)
    assert rows[2] == (
        "| half_cheetah__grbal__s1 | fit/valid_loss_after 0.2685 → 0.1853, "
        "max 0.301, epochs 4.12 | s0 fit/valid_loss_after 0.2785 → 0.1916, "
        "max 0.302, epochs 5.00; s1 fit/valid_loss_after 0.2685 → 0.1853, "
        "max 0.301, epochs 4.12 |")
    assert len(rows) == 3


# ------------------------------------------------------ (v) the loss tag --
def test_the_loss_variant_is_the_references():
    assert LOSS_VARIANT == JAX_LOSS_VARIANT
