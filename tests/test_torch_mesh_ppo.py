"""PPO + CaDM on the port's (dp, model) mesh, gloo ranks on the CPU: a
(dp=2, model=2) and a (dp=2, model=1) run of a 2-member CaDM with a PPO
policy on pendulum (collect on each rank's envs, the rollout gathered and
the PPO update replicated, the fit on gathered batches and split members,
the eval on each rank's envs) against the same run without a mesh, rows
and weights; the sharded run's checkpoint resumes without a mesh.
"""
import pytest
import torch

from cadm_tpu_torch.parallel.mesh import spawn
from cadm_tpu_torch.utils.checkpoint import Checkpointer
from tests import torch_mesh_common as common
from tests.torch_mesh_common import (
    LAYOUTS,
    assert_rows_close,
    assert_weights_close,
)


@pytest.mark.parametrize("dp,model", LAYOUTS)
def test_ppo_on_a_mesh_matches_the_run_without_one(dp, model, tmp_path):
    ref = common.without_mesh(common.train, common.PPO)
    outs = spawn(common.train, dp, model, ["cpu"] * (dp * model),
                 args=(common.PPO, str(tmp_path)))
    for out in outs:
        assert_rows_close(out["history"], ref["history"])
        assert_weights_close(out["params"], ref["params"])
    cfg = common.ExperimentConfig(**common.PPO)
    _, _, _, trainer = cfg.build("cpu")
    *_, rows = trainer.train(torch.Generator().manual_seed(cfg.seed),
                             resume=Checkpointer(str(tmp_path)).restore(0))
    assert_rows_close(rows, ref["history"][1:])
