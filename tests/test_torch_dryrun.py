"""``imagegenerator_tpu_torch/dryrun.py``, the counterpart of
``__graft_entry__.py``: ``entry`` builds the G2 bf16 forward at batch 8
(run here on the ``meta`` device, shapes only; the card runs it in
``chip_smoke.py``), and ``dryrun_multichip(2, device="cpu")`` starts two
gloo ranks and runs its five steps. Both refuse to fall back to the CPU
when the card is wanted and missing."""

import numpy as np
import pytest
import torch

from imagegenerator_tpu_torch import dryrun


def test_entry_is_the_g2_bf16_forward_at_batch_8():
    fn, args = dryrun.entry(device="meta")
    assert [tuple(a.shape) for a in args] == [(8, 64, 64, 3), (8, 128)]
    out = fn(*args)
    assert tuple(out.shape) == (8, 256, 256, 3) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("call", [lambda: dryrun.entry(), lambda: dryrun.dryrun_multichip(2)])
def test_the_card_is_the_default(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_dryrun_multichip_runs_its_five_steps_on_two_ranks():
    report = dryrun.dryrun_multichip(2, device="cpu")
    assert (report["ranks"], report["backend"]) == (2, "gloo")
    for step in ("stage2_dp", "stage1_grid", "stage1_dp_fused"):
        assert all(np.isfinite(v) for v in report[step]["metrics"].values()), step
    assert len(report["v2_sharded"]["last_losses"]) == 2
    assert report["clip_tp"]["grid"] == [1, 2] and report["clip_tp"]["rel_err"] <= 1e-5
    assert report["stage1_grid"]["split_tensors"] == 10  # q, k, v and intermediate: weight and bias; 2 outputs
