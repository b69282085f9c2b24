"""Each analysis as a user runs it, ``python -m cadm_tpu_torch.analysis.<name>
--device cpu``, at toy width on temporary untrained snapshots, in a process
where jax, the JAX package and the reference's scripts cannot be imported:
it exits 0 and writes a JSON with the keys of the reference's record of the
same probe under ``results/`` (and only finite numbers)."""
import json
import math
import os
import subprocess
import sys

import pytest

from chip_smoke import json_numbers, key_paths
from tests.torch_analysis_common import ROOT, port_snapshot, snapshots

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "mujoco", "cadm_tpu",
           "scripts")
RUNNER = ("import runpy, sys\n"
          "for m in {blocked!r}:\n"
          "    sys.modules[m] = None\n"
          "sys.argv = {argv!r}\n"
          "runpy.run_module('cadm_tpu_torch.analysis.{name}', "
          "run_name='__main__')\n")
REC = os.path.join(ROOT, "results")


def cases(tmp, ckpt):
    """name → (arguments, output JSON, the reference's record)."""
    cells = ["cartpole__cadm__s0", "cartpole__pets_cadm__s0"]
    snap = ["--ckpt-dir", ckpt]
    return {
        "probe_epochs": (
            ["--raw", os.path.join(REC, "raw"), "--out", f"{tmp}/e.json"],
            f"{tmp}/e.json", "epochs_audit.json"),
        "probe_context": (
            ["--cell", cells[0], "--rounds", "1", "--n-envs", "4", "--steps",
             "11", "--save-arrays", "--out-dir", tmp, *snap],
            f"{tmp}/{cells[0]}.json", f"context_probe/{cells[0]}.json"),
        "probe_hstep": (
            ["--cell", cells[1], "--ckpt", f"{ckpt}/{cells[1]}.pkl",
             "--n-envs", "4", "--horizon", "5", "--collect-steps", "12",
             "--out-dir", tmp],
            f"{tmp}/{cells[1]}.json", "hstep_probe/cripple_ant__cadm__s0.json"),
        "probe_blowup": (
            ["--cell", cells[1], "--n-envs", "4", "--steps", "12",
             "--candidates", "10", "--out-dir", tmp, *snap],
            f"{tmp}/{cells[1]}.json",
            "blowup_probe/cripple_ant__cadm__s0.json"),
        "probe_dist": (
            ["--gen-cell", cells[0], "--eval-cells", *cells, "--n-envs", "4",
             "--steps", "20", "--candidates", "8", "--horizon", "3",
             "--batches", "2", "--batch", "16", "--out-dir", tmp, *snap],
            f"{tmp}/{cells[0]}.json", "dist_probe/cripple_ant__cadm__s0.json"),
        "probe_ranges": (
            ["--families", "cartpole", "--n-envs", "4", "--horizon", "5",
             "--out", f"{tmp}/r.json", *snap],
            f"{tmp}/r.json", "range_potency.json"),
        "ab_ts1": (
            ["--steps", "5", "--draws", "2", "--episodes", "2",
             "--closed-loop-steps", "3", "--out", f"{tmp}/ab.json"],
            f"{tmp}/ab.json", "ab_ts1.json"),
    }


@pytest.mark.parametrize("name", ["probe_epochs", "probe_context",
                                  "probe_hstep", "probe_blowup", "probe_dist",
                                  "probe_ranges", "ab_ts1"])
def test_the_cli_runs_without_jax_and_writes_the_records_keys(name,
                                                              tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for cell in ("cartpole__cadm__s0", "cartpole__vanilla__s0"):
        port_snapshot(cell, ckpt)
    snapshots("cartpole__pets_cadm__s0", ckpt)
    args, out_file, record = cases(str(tmp_path), str(ckpt))[name]
    argv = [name, *args, *([] if name == "probe_epochs" else
                           ["--device", "cpu"])]
    code = RUNNER.format(blocked=BLOCKED, argv=argv, name=name)
    # one intra-op thread: the suite's workers already use every core
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=ROOT,
                                  OMP_NUM_THREADS="1", MKL_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out_file) as f:
        out = json.load(f)
    with open(os.path.join(REC, record)) as f:
        ref = json.load(f)
    if name == "probe_ranges":   # one family's record against another's
        ref, out = ref["hopper"], out["cartpole"]
        assert sorted(out["scales"]["1.0"]) == sorted(ref["scales"]["1.0"])
    if name == "probe_context":
        assert os.path.exists(out_file[:-5] + ".npz")
    missing = key_paths(ref) - key_paths(out)
    assert not missing, missing
    assert all(math.isfinite(v) for _, v in json_numbers(out))
