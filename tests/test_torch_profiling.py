"""The port's profiling hooks (``utils/profiling.py``) on the CPU: ``trace``
writes one Chrome trace per rank with the block's operators in it, and
nothing when the block raises; ``step_timer`` and ``fence`` as in the JAX
package's ``utils/profiling.py``. The CLIs' ``--profile_dir`` runs are in
``tests/test_torch_train_cli.py`` and ``tests/test_torch_generate_cli.py``."""

import json

import pytest
import torch

from imagegenerator_tpu_torch.utils import profiling


def test_trace_writes_one_file_per_rank(tmp_path, capsys):
    logdir = tmp_path / "prof"
    with profiling.trace(str(logdir)):
        torch.nn.functional.conv2d(torch.randn(1, 3, 8, 8), torch.randn(4, 3, 3, 3)).sum()
    assert sorted(p.name for p in logdir.iterdir()) == ["trace_rank0.json"]
    assert profiling.trace_path(str(logdir)) == str(logdir / "trace_rank0.json")
    assert profiling.trace_path("d", rank=3).endswith("trace_rank3.json")
    events = json.loads((logdir / "trace_rank0.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::conv2d" for e in events)
    assert "[profile] trace written to" in capsys.readouterr().out
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path / "failed")):
            raise ValueError("the block failed")
    assert not (tmp_path / "failed" / "trace_rank0.json").exists()


def test_step_timer_and_fence(capsys):
    found = {}
    with profiling.step_timer("step", found):
        x = torch.ones(3) * 2
        profiling.fence({"out": [x, (x, 1)], "n": 3})
    assert found["step"] > 0
    with profiling.step_timer("printed"):
        pass
    assert capsys.readouterr().out.startswith("[timer] printed: ")
    profiling.fence(None)
