"""``tools/jax_checkpoint_to_port.py``: a training run's checkpoint
carried from the JAX package (Orbax) to the port (``.npz``) and back, on
the CPU at the tiny configs of ``tests/test_torch_stage{1,2}_step.py``.

JAX -> port: tiny JAX trainers save stage 1 (text dropout off, so that
the step's draws replay) and stage 2 (with ``ema_decay``) after one epoch
of two steps; the tool converts; the port's trainer resumes from the
result (``Loaded checkpoint at epoch 0``) with the JAX state bit for bit,
EMA included, and its next step matches the JAX trainer's next step at
the step tests' tolerances; the EMA's update then differs from JAX's by
(1 - decay) times the parameters' difference. ``train.sample --ema`` and
``train.cli --stage1_checkpoint`` read the converted runs.

Port -> JAX: the port's trainers save; the tool converts to Orbax; the
JAX trainers resume from it with the port's state (and EMA) bit for bit,
and the JAX step from there matches the port's next step. (A ``--tp 2``
run goes back in ``tests/test_torch_tp.py``.)

Bad input raises: no marker, metadata that cannot be read, a state of
other keys or shapes."""

import contextlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from imagegenerator_tpu.train import ema as jema
from imagegenerator_tpu.train import stage1 as js1
from imagegenerator_tpu.train import stage2 as js2
from imagegenerator_tpu.train.trainer import Stage1Trainer as JStage1Trainer
from imagegenerator_tpu.train.trainer import Stage2Trainer as JStage2Trainer
from imagegenerator_tpu.train.trainer import TrainerOptions as JTrainerOptions
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.checkpoint import CheckpointManager
from imagegenerator_tpu_torch.train import ema as tema
from imagegenerator_tpu_torch.train import sample, stage1 as ts1, stage2 as ts2
from imagegenerator_tpu_torch.train.trainer import Stage1Trainer, Stage2Trainer, TrainerOptions
from tests import test_torch_stage1_step as t1
from tests import test_torch_stage2_step as t2

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import jax_checkpoint_to_port as bridge  # noqa: E402

torch.set_num_threads(2)
DECAY = 0.9
FLAGS = {1: ["--stage", "1", "--tiny", "--n_critic", "2"], 2: ["--stage", "2", "--tiny", "--n_critic", "2"]}


def _configs(stage):
    if stage == 1:
        return (js1.Stage1Config.tiny(n_critic=2, text_dropout=False),
                ts1.Stage1Config.tiny(n_critic=2, text_dropout=False))
    return js2.Stage2Config.tiny(n_critic=2), ts2.Stage2Config.tiny(n_critic=2)


def _batches(stage, tcfg):
    if stage == 1:
        return [t1._batch(tcfg, False, seed=s) for s in (0, 1, 2)]
    return [t2._batch(tcfg, "tokens", False, seed=s) for s in (0, 1, 2)]


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _noise(stage, system, state, key):
    return t1._noise(system, state, key) if stage == 1 else t2.jax_noise(system, state, key)


def _flat_ema(ema) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(ema, sep="/").items()}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per stage: a JAX tiny trainer's run of one epoch (two steps) saved
    under ``<root>/Stage{N}`` (stage 2 with EMA), its final state and
    EMA, and the trainer, whose compiled step the tests reuse."""
    root = tmp_path_factory.mktemp("jax_run")
    runs = {}
    for stage in (1, 2):
        jcfg, tcfg = _configs(stage)
        system = (js1.Stage1System if stage == 1 else js2.Stage2System)(jcfg)
        options = JTrainerOptions(num_epochs=1, seed=7, checkpoint_dir=str(root / f"Stage{stage}"),
                                  ema_decay=DECAY if stage == 2 else None)
        batches = _batches(stage, tcfg)
        trainer = (JStage1Trainer if stage == 1 else JStage2Trainer)(system, [_jax(b) for b in batches[:2]],
                                                                    options)
        state, start = trainer.init_state(t1.B)
        assert start == 0
        with contextlib.redirect_stdout(io.StringIO()):
            state = trainer.fit(state, start)
        runs[stage] = dict(root=root, system=system, trainer=trainer, state=state, tcfg=tcfg, batches=batches,
                           flat=bridge.jax_flat(state, bridge.fields(stage)),
                           ema=None if trainer.ema is None else _flat_ema(trainer.ema))
    return runs


def _port_trainer(stage, tcfg, checkpoint_dir, ema, loader=()):
    system = (ts1.Stage1System if stage == 1 else ts2.Stage2System)(
        tcfg, device="cpu", generator=torch.Generator().manual_seed(5))
    options = TrainerOptions(num_epochs=1, seed=3, checkpoint_dir=checkpoint_dir, ema_decay=DECAY if ema else None)
    return system, (Stage1Trainer if stage == 1 else Stage2Trainer)(system, list(loader), options)


def _next_steps_agree(stage, run, port_system, jstate, what):
    """One step of each side from the same state: the port's against the
    JAX trainer's compiled step, at the step tests' tolerances. Returns
    the JAX state after it."""
    key = jax.random.key(41)
    batch = run["batches"][2]
    noise = _noise(stage, run["system"], jstate, key)
    new_state, want = run["trainer"].step_fn(jstate, _jax(batch), key)
    got = port_system.train_step(_torch(batch), noise=noise)
    t1._metrics_close(got, want, what)
    t1.assert_state_close(port_system, new_state, run["tcfg"], what, bridge.fields(stage))
    return new_state


@pytest.mark.parametrize("stage", [1, 2])
def test_a_jax_run_resumes_in_the_port(stage, jax_runs, tmp_path, capsys):
    run = jax_runs[stage]
    assert bridge.main(FLAGS[stage] + ["--checkpoint_dir", str(run["root"]), "--out_dir", str(tmp_path)]) == 0
    layout = tmp_path / f"Stage{stage}"
    assert (layout / "LATEST_EPOCH").read_text() == "0"
    assert (layout / "epochs" / "checkpoint_epoch_0" / "state.npz").exists() and (layout / "latest" / "state.npz").exists()
    system, trainer = _port_trainer(stage, run["tcfg"], str(layout), run["ema"] is not None)
    assert trainer.init_state() == 1
    assert "Loaded checkpoint at epoch 0" in capsys.readouterr().out
    flat = convert.to_numpy(system)
    assert set(flat) == set(run["flat"]) and system.step == 2
    for k, v in run["flat"].items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    if run["ema"] is not None:
        ema = tema.to_numpy(trainer.ema, system)
        assert set(ema) == set(run["ema"])
        for k, v in run["ema"].items():
            np.testing.assert_array_equal(ema[k], v, err_msg=k)
    jstate = bridge.jax_state_from_flat(run["state"], run["flat"], bridge.fields(stage))
    new_state = _next_steps_agree(stage, run, system, jstate, f"stage {stage} jax -> port")
    if run["ema"] is not None:  # the EMA's update: exactly what the parameters' difference makes of it
        tema.update(trainer.ema, system, DECAY)
        jax_ema = _flat_ema(run["trainer"]._ema_update(
            jax.tree.map(jnp.asarray, traverse_util.unflatten_dict(
                {tuple(k.split("/")): v for k, v in run["ema"].items()})),
            jema.tracked(new_state.params, run["trainer"].ema)))
        got, params = tema.to_numpy(trainer.ema, system), convert.to_numpy(system)
        want_params = bridge.jax_flat(new_state, bridge.fields(stage))
        for k, v in jax_ema.items():
            shift = (1 - DECAY) * (params[f"params/{k}"] - want_params[f"params/{k}"])
            np.testing.assert_allclose(got[k] - v, shift, rtol=0, atol=1e-6, err_msg=k)


def test_the_converted_runs_feed_the_port_clis(jax_runs, tmp_path):
    """``train.sample --ema`` on the converted stage-2 run, ``train.cli``
    resuming the converted stage-1 run, and ``train.cli --stage 2
    --stage1_checkpoint`` on it."""
    from imagegenerator_tpu_torch.train import cli
    from tests.test_torch_train_cli import _dataset

    for stage in (1, 2):
        bridge.main(FLAGS[stage] + ["--checkpoint_dir", str(jax_runs[stage]["root"]), "--out_dir", str(tmp_path)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sample.main(["--stage", "2", "--tiny", "--device", "cpu", "--checkpoint_dir", str(tmp_path), "--ema",
                     "--caption", "a red bus|two dogs", "-o", str(tmp_path / "samples")])
    assert "Loaded checkpoint at epoch 0" in out.getvalue()
    assert len(list((tmp_path / "samples").glob("*.png"))) == 2
    data = tmp_path / "ds"
    _dataset(data)
    common = ["--tiny", "--device", "cpu", "--data", str(data), "--root", "imgs", "--ann_file", "ann/captions.json",
              "--batch_size", "2", "--num_epochs", "1", "--n_critic", "1", "--seq_len", "8"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):  # epoch 0 is done: the resume takes no step
        cli.main(["--stage", "1", "--checkpoint_dir", str(tmp_path)] + common)
    assert "Loaded checkpoint at epoch 0" in out.getvalue() and "step " not in out.getvalue()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["--stage", "2", "--checkpoint_dir", str(tmp_path / "stage2_from_jax_stage1"),
                  "--stage1_checkpoint", str(tmp_path / "Stage1")] + common)
    flat, _ = CheckpointManager(str(tmp_path / "stage2_from_jax_stage1" / "Stage2")).restore_latest()
    key = "frozen_params/gen_1/UpBlock_0/ConvTranspose2d_0/kernel"
    want = jax_runs[1]["flat"]["params/generator/UpBlock_0/ConvTranspose2d_0/kernel"]
    np.testing.assert_array_equal(flat[key], want)


@pytest.mark.parametrize("stage", [1, 2])
def test_a_port_run_resumes_in_jax(stage, jax_runs, tmp_path, capsys):
    run = jax_runs[stage]
    port_dir = tmp_path / "port"
    system, trainer = _port_trainer(stage, run["tcfg"], str(port_dir / f"Stage{stage}"), stage == 2,
                                    [_torch(b) for b in run["batches"][:2]])
    trainer.init_state()
    trainer.fit()
    flat, aux, start = CheckpointManager(str(port_dir / f"Stage{stage}")).restore_latest_with_aux()
    assert start == 1 and int(flat["step"]) == 2
    assert bridge.main(FLAGS[stage] + ["--to", "jax", "--checkpoint_dir", str(port_dir),
                                       "--out_dir", str(tmp_path / "jax")]) == 0
    jcfg, _ = _configs(stage)
    jsys = (js1.Stage1System if stage == 1 else js2.Stage2System)(jcfg)
    options = JTrainerOptions(num_epochs=2, checkpoint_dir=str(tmp_path / "jax" / f"Stage{stage}"),
                              ema_decay=DECAY if stage == 2 else None)
    jtrainer = (JStage1Trainer if stage == 1 else JStage2Trainer)(jsys, [], options)
    capsys.readouterr()
    jstate, jstart = jtrainer.init_state(t1.B)
    assert jstart == 1 and "Loaded checkpoint at epoch 0" in capsys.readouterr().out
    restored = bridge.jax_flat(jstate, bridge.fields(stage))
    assert set(restored) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
    if stage == 2:
        ema = _flat_ema(jtrainer.ema)
        assert {f"ema/{k}" for k in ema} == set(aux)
        for k, v in ema.items():
            np.testing.assert_array_equal(v, aux[f"ema/{k}"], err_msg=k)
    _next_steps_agree(stage, run, system, jstate, f"stage {stage} port -> jax")


def test_bad_input_raises(jax_runs, tmp_path):
    run = jax_runs[1]
    convert_args = FLAGS[1] + ["--checkpoint_dir", str(run["root"]), "--out_dir", str(tmp_path / "out")]
    with pytest.raises(FileNotFoundError, match="LATEST_EPOCH"):
        bridge.main(FLAGS[1] + ["--checkpoint_dir", str(tmp_path / "absent"), "--out_dir", str(tmp_path / "o")])
    with pytest.raises(FileNotFoundError, match="LATEST_EPOCH"):
        bridge.main(FLAGS[1] + ["--to", "jax", "--checkpoint_dir", str(tmp_path / "absent"),
                                "--out_dir", str(tmp_path / "o")])
    # the flags of another config (the full widths): other keys and shapes
    with pytest.raises(ValueError, match="not the target state"):
        bridge.main([a for a in convert_args if a != "--tiny"])
    assert not (tmp_path / "out").exists()
    # the metadata of a copy of the run, absent and then unreadable
    import shutil

    copy = tmp_path / "copy"
    shutil.copytree(run["root"] / "Stage1", copy / "Stage1")
    meta = copy / "Stage1" / "epochs" / "checkpoint_epoch_0" / "_METADATA"
    meta.unlink()
    with pytest.raises(ValueError, match="metadata"):
        bridge.main(FLAGS[1] + ["--checkpoint_dir", str(copy), "--out_dir", str(tmp_path / "o2")])
    meta.write_text("{not json")
    with pytest.raises(ValueError, match="metadata"):
        bridge.main(FLAGS[1] + ["--checkpoint_dir", str(copy), "--out_dir", str(tmp_path / "o3")])
    assert not (tmp_path / "o2").exists() and not (tmp_path / "o3").exists()
    # a port checkpoint with a key the JAX state does not have
    bridge.main(convert_args)
    mgr = CheckpointManager(str(tmp_path / "out" / "Stage1"))
    flat, _ = mgr.restore_latest()
    flat["params/generator/extra"] = np.zeros(3, np.float32)
    mgr.save(0, flat)
    with pytest.raises(ValueError, match="does not have"):
        bridge.main(FLAGS[1] + ["--to", "jax", "--checkpoint_dir", str(tmp_path / "out"),
                                "--out_dir", str(tmp_path / "o4")])
