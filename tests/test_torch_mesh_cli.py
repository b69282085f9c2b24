"""The CLI on a mesh: ``torchrun --standalone --nproc-per-node 4 -m
cadm_tpu_torch.cli.run --device cpu --dp 2 --model-par 2`` (4 gloo ranks on
the CPU, rank 0 writing the log) gives the ``progress.csv`` of the same run
without a mesh, within float32 reduction order.
"""
import csv
import os
import subprocess
import sys

import numpy as np

from cadm_tpu_torch.cli import run
from tests import torch_mesh_common as common
from tests.torch_mesh_common import ROW_RTOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_torchrun_cli_on_a_dp2_model2_mesh(tmp_path):
    fields = dict(common.PENDULUM, eval_modes=(0,))
    flags = ["--device", "cpu", "--log-dir", str(tmp_path)]
    for k, v in fields.items():
        flags += ["--" + k.replace("_", "-"),
                  ",".join(map(str, v)) if isinstance(v, tuple) else str(v)]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "cadm_tpu_torch.cli.run", *flags,
         "--dp", "2", "--model-par", "2", "--exp-name", "mesh"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "backend=gloo" in out.stdout
    common.without_mesh(lambda _: run.main([*flags, "--exp-name", "plain"]))
    mesh, plain = (rows(tmp_path / name / "progress.csv")
                   for name in ("mesh", "plain"))
    assert len(mesh) == len(plain) == fields["n_itr"]
    for a, b in zip(mesh, plain):
        assert list(a) == list(b)
        np.testing.assert_allclose([float(a[k]) for k in a],
                                   [float(b[k]) for k in b], rtol=ROW_RTOL,
                                   atol=1e-6)
    # rank 0 alone writes the experiment's files
    assert sorted(os.listdir(tmp_path / "mesh")) == [
        "debug.log", "params.json", "progress.csv"]
