"""The probes' snapshot loader (``cadm_tpu_torch/analysis/snapshot.py``):
the matrix runner's ``.pt`` snapshot reads back as the state it saved, a
``cli.run --checkpoint`` payload as its model state; a snapshot of another
configuration is refused; the reference's pickled
snapshot (``scripts/run_matrix.py::save_snapshot``'s numpy pytree) loads
without importing the JAX package and equals the JAX state leaf for leaf,
Adam state included; the width overrides reach the config; the card is
the default device."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.torch_analysis_common import ROOT, snapshots
from cadm_tpu_torch.analysis import snapshot
from cadm_tpu_torch.cli import matrix
from cadm_tpu_torch.core.types import tree_leaves
from cadm_tpu_torch.utils.checkpoint import Checkpointer, to_plain


def test_the_runners_snapshot_reads_back(tmp_path, monkeypatch):
    cell = "cartpole__pets_cadm__s0"
    _, dyn, _, _ = snapshot.cell_config(cell).build("cpu")
    state = dyn.init_state(torch.Generator().manual_seed(3))
    state.updates = 7
    monkeypatch.setattr(matrix, "CKPT_DIR", str(tmp_path))
    matrix.save_snapshot(cell, state)
    cfg, _, _, _, trainer, loaded = snapshot.load_cell(
        cell, device="cpu", ckpt_dir=str(tmp_path), n_envs=3)
    assert (cfg.n_envs, trainer.cfg.n_envs, cfg.ensemble) == (3, 3, 5)
    assert loaded.updates == 7 and loaded.opt_state.count == 0
    for part in ("params", "norm", "opt_state"):
        a, b = (to_plain(getattr(x, part)) for x in (loaded, state))
        if part == "opt_state":
            a, b = [a["mu"], a["nu"]], [b["mu"], b["nu"]]
        for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
            assert torch.equal(x, y), part


def test_a_cli_checkpoint_reads_as_its_model_state(tmp_path):
    """``cli.run --checkpoint``'s whole training payload: its ``state``."""
    cell = "cartpole__cadm__s0"
    _, dyn, _, trainer = snapshot.cell_config(cell).build("cpu")
    gen = torch.Generator().manual_seed(1)
    env_states, hists, buffer, state = trainer.init(gen)
    Checkpointer(str(tmp_path)).save(0, trainer.checkpoint_payload(
        env_states, hists, buffer, state, gen, 0))
    loaded = snapshot.read_snapshot(dyn, str(tmp_path / "step_0.pt"), "cpu")
    for x, y in zip(tree_leaves(loaded.params), tree_leaves(state.params),
                    strict=True):
        assert torch.equal(x, y)


def test_another_configurations_snapshot_is_refused(tmp_path):
    snapshots("cartpole__pets_cadm__s0", tmp_path)
    with pytest.raises(ValueError, match="checkpoint"):
        snapshot.load_cell("cartpole__cadm__s0", device="cpu",
                           path=str(tmp_path / "cartpole__pets_cadm__s0.pt"))


def test_a_reference_snapshot_loads_without_jax(tmp_path):
    cell = "cartpole__pets_cadm__s0"
    jstate, state = snapshots(cell, tmp_path)
    pkl = str(tmp_path / (cell + ".pkl"))
    via_stub = snapshot.read_snapshot(
        snapshot.load_cell(cell, device="cpu", path=pkl)[2], pkl, "cpu")
    ref = jax.tree.map(np.asarray, jstate)
    assert via_stub.opt_state.count == int(ref.opt_state[1][0].count)
    for ours, theirs in ((via_stub.params, ref.params),
                         (via_stub.opt_state.mu, ref.opt_state[1][0].mu),
                         (via_stub.norm.dobs_std, ref.norm.dobs_std)):
        a, b = tree_leaves(ours), jax.tree.leaves(theirs)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y)
    # in a process where the JAX side cannot be imported at all
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'cadm_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from cadm_tpu_torch.analysis.snapshot import read_jax_snapshot\n"
            "from cadm_tpu_torch.analysis.snapshot import dyn_state_from_jax\n"
            f"s = dyn_state_from_jax(read_jax_snapshot({pkl!r}), 'cpu')\n"
            "print(s.params['fwd'][0]['w'].shape[0], int(s.opt_state.count))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["5", "0"]


def test_the_card_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        snapshot.load_cell("cartpole__cadm__s0", ckpt_dir=str(tmp_path))
