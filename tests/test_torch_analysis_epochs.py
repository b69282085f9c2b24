"""The port's epoch-cap audit (``cadm_tpu_torch/analysis/probe_epochs.py``)
against scripts/probe_epochs.py: its rows equal ``audit_cell``'s on every
cell JSON of the reference's ``results/raw/``, exactly, and its file holds
them."""
import glob
import json
import os

import scripts.probe_epochs as jax_probe
from cadm_tpu_torch.analysis import probe_epochs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = os.path.join(ROOT, "results", "raw")


def test_rows_equal_the_scripts_on_every_recorded_cell():
    paths = sorted(glob.glob(os.path.join(RAW, "*.json")))
    assert len(paths) > 50
    for path in paths:
        assert probe_epochs.audit_cell(path) == jax_probe.audit_cell(path), \
            path


def test_main_writes_the_audit(tmp_path, capsys):
    out = tmp_path / "audit.json"
    rows = probe_epochs.main(["--raw", RAW, "--out", str(out)])
    ref = [r for r in map(jax_probe.audit_cell,
                          sorted(glob.glob(os.path.join(RAW, "*.json"))))
           if r is not None]
    assert rows == ref and json.loads(out.read_text()) == ref
    assert f"wrote {out}" in capsys.readouterr().out
