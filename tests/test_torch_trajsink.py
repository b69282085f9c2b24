"""The port's binding of the native trajectory sink (as tests/test_trajsink.py),
the trainer's per-iteration dump through it, and the port's debug and
profiling utilities (``assert_finite``, ``checked``, ``PhaseTimer``,
``device_trace``).
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from cadm_tpu_torch.cli.presets import PRESETS
from cadm_tpu_torch.utils.debug import assert_finite, checked
from cadm_tpu_torch.utils.profiling import PhaseTimer, device_trace
from cadm_tpu_torch.utils.trajsink import TrajectorySink, read_trajfile


@pytest.fixture
def sink_available():
    if not TrajectorySink.available():
        pytest.skip("no g++ to build the native sink")


def test_roundtrip(tmp_path, sink_available):
    path = str(tmp_path / "traj.bin")
    s = TrajectorySink(path)
    rng = np.random.RandomState(0)
    arrays = {
        "obs": rng.randn(16, 17).astype(np.float32),
        "act": rng.randn(16, 6).astype(np.float32),
        "ep_step": np.arange(16, dtype=np.int32),
    }
    for k, v in arrays.items():
        assert s.append(k, v)
    s.flush()
    assert s.written == 2 * len(arrays) and s.dropped == 0
    s.close()
    out = dict(read_trajfile(path))
    assert set(out) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(out[k], arrays[k])
        assert out[k].dtype == arrays[k].dtype


def test_backpressure_drops_not_blocks(tmp_path, sink_available):
    s = TrajectorySink(str(tmp_path / "t2.bin"), max_queue_mb=1)
    assert not s.append("big", np.zeros((600_000,), np.float32))  # 2.4 MB
    assert s.dropped >= 1
    s.close()


def test_meta_array_pairs_drop_atomically(tmp_path, sink_available):
    """Under queue pressure META and ARRAY drop together: no ARRAY is ever
    paired with a stale META."""
    path = str(tmp_path / "pressure.bin")
    s = TrajectorySink(path, max_queue_mb=1)
    n_ok = sum(s.append(f"a{i}", np.full((180_000,), i, np.float32))
               for i in range(50))
    s.flush()
    s.close()
    assert n_ok >= 1
    out = dict(read_trajfile(path))
    assert len(out) == n_ok
    for name, arr in out.items():
        assert (arr == int(name[1:])).all(), name


def test_flush_is_durable(tmp_path, sink_available):
    path = str(tmp_path / "durable.bin")
    s = TrajectorySink(path)
    rng = np.random.RandomState(1)
    for rep in range(20):
        assert s.append(f"x{rep}", rng.randn(100_000).astype(np.float32))
        s.flush()
        assert [n for n, _ in read_trajfile(path)] == [f"x{k}"
                                                       for k in range(rep + 1)]
    s.close()


def test_read_trajfile_refuses_other_files(tmp_path):
    path = tmp_path / "other.bin"
    path.write_bytes(b"not a sink file at all")
    with pytest.raises(ValueError, match="not a trajectory sink"):
        list(read_trajfile(str(path)))


def test_trainer_dumps_each_iterations_transitions(tmp_path, sink_available):
    """Each iteration's itr{n}/obs|act|next_obs, (n_envs, steps, dim), equal
    to the ring's columns of that iteration."""
    cfg = dataclasses.replace(
        PRESETS["halfcheetah_cadm_cem"], hidden=(8,), n_envs=2, eval_envs=1,
        eval_modes=(0,), n_candidates=4, plan_horizon=2, cem_iters=1,
        cem_elites=2, n_itr=2, steps_per_itr=2, env_horizon=2,
        buffer_capacity=12, batch_size=4, max_epochs=1, eval_every=2)
    _, _, _, trainer = cfg.build("cpu")
    path = str(tmp_path / "trajectories.bin")
    sink = TrajectorySink(path)
    rings = []
    collect = trainer._collect

    def keep_ring(*args, **kwargs):
        out = collect(*args, **kwargs)
        rings.append({k: getattr(out[2], k).clone()
                      for k in ("obs", "act", "next_obs")})
        return out

    trainer._collect = keep_ring
    trainer.train(torch.Generator().manual_seed(0), traj_sink=sink)
    sink.flush()
    assert sink.written == 12 and sink.dropped == 0
    sink.close()
    out = dict(read_trajfile(path))
    assert sorted(out) == sorted(f"itr{i}/{k}" for i in range(2)
                                 for k in ("obs", "act", "next_obs"))
    for i, ring in enumerate(rings):
        for k, v in ring.items():
            assert out[f"itr{i}/{k}"].shape == (2, 2, v.shape[-1])
            np.testing.assert_array_equal(out[f"itr{i}/{k}"],
                                          v[:, 2 * i: 2 * i + 2].numpy())


def test_assert_finite_names_the_offending_leaf():
    @dataclasses.dataclass
    class State:
        params: dict
        count: int

    good = State({"fwd": [{"w": torch.ones(2), "b": torch.zeros(2)}]}, 3)
    assert_finite(good, "after the fit")
    bad = State({"fwd": [{"w": torch.ones(2),
                          "b": torch.tensor([0.0, math.inf])}]}, 3)
    with pytest.raises(FloatingPointError,
                       match=r"\.params\['fwd'\]\[0\]\['b'\] after the fit"):
        assert_finite(bad, "after the fit")
    assert_finite({"idx": torch.tensor([1, 2])})  # integer leaves are skipped


def test_checked_raises_on_non_finite_outputs_only():
    def div(a, b):
        return {"q": a / b, "n": b}

    safe = checked(div)
    assert safe(torch.ones(2), torch.ones(2))["q"].tolist() == [1.0, 1.0]
    with pytest.raises(FloatingPointError, match=r"\['q'\].*div"):
        safe(torch.ones(2), torch.zeros(2))
    # an intermediate NaN that does not reach the output is not seen
    checked(lambda x: torch.nan_to_num(x / 0.0, nan=0.0, posinf=0.0))(
        torch.zeros(2))


def test_phase_timer():
    t = PhaseTimer()
    for _ in range(2):
        with t.phase("fit") as out:
            out["result"] = torch.ones(8) * 2
    with t.phase("collect"):
        pass
    s = t.summary()
    assert sorted(s) == ["time/collect_sec_per_call", "time/fit_sec_per_call"]
    assert s["time/fit_sec_per_call"] >= 0 and t.counts["fit"] == 2


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert os.listdir(tmp_path / "tr") == ["trace.json"]
