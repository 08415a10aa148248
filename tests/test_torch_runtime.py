"""The port's training runtime on the CPU at the tiny configs: the EMA
(``train/ema.py``) against the JAX package's ``make_ema_update``
(rtol 1e-6), the ``CheckpointManager``'s contract (layout on disk, marker
after payload, plain and ``{"state", "aux"}`` round trips, a torn
checkpoint raises), the trainers (resume, EMA side dict, metric names,
stage 2's sample grids), and a port checkpoint read into a JAX
``Stage2State`` from which the JAX step continues to the port's next step
(the stage-2 step test's tolerances, 1e-4)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from imagegenerator_tpu.train import ema as jema
from imagegenerator_tpu.train import stage2 as js2
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.checkpoint import CheckpointManager
from imagegenerator_tpu_torch.train import ema as tema
from imagegenerator_tpu_torch.train import stage1 as ts1
from imagegenerator_tpu_torch.train import stage2 as ts2
from imagegenerator_tpu_torch.train.trainer import Stage1Trainer, Stage2Trainer, TrainerOptions
from imagegenerator_tpu_torch.utils.rng import mixed_generator
from tests.test_torch_stage1_step import _metrics_close, assert_state_close, jax_state_from_flat
from tests.test_torch_stage2_step import FIELDS, jax_noise

torch.set_num_threads(2)
B = 4


def _system(stage=2, seed=0, **kw):
    if stage == 1:
        cfg = ts1.Stage1Config.tiny(n_critic=1, **kw)
        return ts1.Stage1System(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    cfg = ts2.Stage2Config.tiny(n_critic=2, **kw)
    return ts2.Stage2System(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    T, r = cfg.seq_len, cfg.resolution
    out = []
    for _ in range(n):
        lengths = rng.integers(3, T + 1, B)
        out.append({
            "input_ids": torch.from_numpy(rng.integers(3, cfg.bert.vocab_size, (B, T)).astype(np.int32)),
            "attention_mask": torch.from_numpy((np.arange(T)[None] < lengths[:, None]).astype(np.int32)),
            "image": torch.from_numpy(rng.integers(0, 256, (B, r, r, 3)).astype(np.uint8)),
        })
    return out


def _flat_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------- EMA


@pytest.mark.parametrize("stage", [1, 2])
def test_ema_matches_jax_over_three_updates(stage):
    assert tema.modules_for_stage(stage) == jema.modules_for_stage(stage)
    system = _system(stage)
    modules = tema.modules_for_stage(stage)
    ema = tema.init_ema(system, modules)
    assert {k.split("/")[0] for k in ema} == set(modules)
    tree = lambda flat: traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    jax_ema = tree(tema.to_numpy(ema, system))
    update = jema.make_ema_update(0.9)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        with torch.no_grad():
            for p in system.parameters():
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
        live = {k: v for k, v in tema.to_numpy(tema.init_ema(system, modules), system).items()}
        jax_ema = update(jax_ema, tree(live))
        tema.update(ema, system, 0.9)
    want = {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(jax_ema).items()}
    got = tema.to_numpy(ema, system)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7, err_msg=k)
        assert not np.allclose(got[k], live[k]) or w.size < 2, k


def test_ema_is_a_copy_and_swaps_in():
    system = _system(2)
    ema = tema.init_ema(system, tema.STAGE2_MODULES)
    before = convert.to_numpy(system)
    with torch.no_grad():
        for p in system.parameters():
            p.mul_(2.0)
    doubled = convert.to_numpy(system)
    # the EMA did not move with the parameters
    _flat_equal(tema.to_numpy(ema, system),
                {k[len("params/"):]: v for k, v in before.items()
                 if k.startswith(("params/con_augment_2/", "params/generator/"))})
    # numpy round trip, then the averages in place of the tracked modules only
    back = tema.from_numpy(tema.to_numpy(ema, system), system, "cpu")
    assert all(torch.equal(back[k], ema[k]) for k in ema)
    tema.swap_in(system, back)
    after = convert.to_numpy(system)
    for k in before:
        tracked = k.startswith(("params/con_augment_2/", "params/generator/"))
        want = before[k] if tracked or not k.startswith(("params/", "frozen_params/")) else doubled[k]
        assert np.array_equal(after[k], want), k


# --------------------------------------------------- CheckpointManager


def _flat(seed):
    rng = np.random.default_rng(seed)
    return {"params/generator/w": rng.standard_normal((3, 2)).astype(np.float32),
            "opt_state/generator/count": np.asarray(seed, np.int32),
            "step": np.asarray(7 + seed, np.int32)}


def test_manager_layout_and_plain_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "Stage1"), save_every_epochs=10)
    assert [e for e in range(25) if mgr.should_save(e)] == [0, 10, 20]
    assert mgr.restore_latest() == (None, 0)
    assert mgr.restore_latest_with_aux() == (None, None, 0)
    assert mgr.latest_epoch() == -1
    mgr.save(0, _flat(0))
    mgr.save(10, _flat(1))
    found = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "Stage1")
                   for d, _, files in os.walk(tmp_path / "Stage1") for f in files)
    assert found == ["LATEST_EPOCH", "epochs/checkpoint_epoch_0/state.npz",
                     "epochs/checkpoint_epoch_10/state.npz", "latest/state.npz"]
    assert (tmp_path / "Stage1" / "LATEST_EPOCH").read_text() == "10"
    flat, start = CheckpointManager(str(tmp_path / "Stage1")).restore_latest()
    assert start == 11
    _flat_equal(flat, _flat(1))
    with np.load(tmp_path / "Stage1" / "latest" / "state.npz") as f:
        _flat_equal(dict(f), _flat(1))
    with np.load(tmp_path / "Stage1" / "epochs" / "checkpoint_epoch_0" / "state.npz") as f:
        _flat_equal(dict(f), _flat(0))
    flat, aux, start = mgr.restore_latest_with_aux()
    assert aux is None and start == 11
    _flat_equal(flat, _flat(1))


def test_manager_composite_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    aux = {"ema/generator/w": np.full((3, 2), 0.5, np.float32)}
    mgr.save_with_aux(3, _flat(2), aux)
    with np.load(tmp_path / "epochs" / "checkpoint_epoch_3" / "state.npz") as f:
        assert sorted(f.files) == ["aux/ema/generator/w", "state/opt_state/generator/count",
                                   "state/params/generator/w", "state/step"]
    flat, got_aux, start = mgr.restore_latest_with_aux()
    assert start == 4
    _flat_equal(flat, _flat(2))
    _flat_equal(got_aux, aux)
    flat, start = mgr.restore_latest()  # the live state, the aux dropped
    assert start == 4
    _flat_equal(flat, _flat(2))


def test_manager_writes_the_marker_after_the_payload(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, _flat(0))
    order = []
    replace = os.replace
    monkeypatch.setattr(os, "replace", lambda a, b: (order.append(os.path.relpath(b, tmp_path)), replace(a, b)))
    mgr.save(1, _flat(1))
    assert order == ["epochs/checkpoint_epoch_1/state.npz", "latest/state.npz", "LATEST_EPOCH"]
    assert not [f for _, _, files in os.walk(tmp_path) for f in files if f.endswith(".tmp")]

    # a save that dies while writing leaves the marker on the last complete epoch
    def torn(file, **arrays):
        file.write(b"PK torn")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", torn)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, _flat(2))
    monkeypatch.undo()
    assert mgr.latest_epoch() == 1
    flat, start = mgr.restore_latest()
    assert start == 2
    _flat_equal(flat, _flat(1))


def test_manager_raises_on_a_checkpoint_it_cannot_read(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, _flat(0))
    (tmp_path / "LATEST_EPOCH").write_text("5")  # names an epoch that is not there
    with pytest.raises(FileNotFoundError):
        mgr.restore_latest()
    (tmp_path / "LATEST_EPOCH").write_text("0")
    path = tmp_path / "epochs" / "checkpoint_epoch_0" / "state.npz"
    path.write_bytes(path.read_bytes()[:100])  # torn, although latest/ is whole
    with pytest.raises(Exception) as e:
        mgr.restore_latest()
    assert not isinstance(e.value, AssertionError)
    with pytest.raises(Exception):
        mgr.restore_latest_with_aux()
    (tmp_path / "LATEST_EPOCH").write_text("not a number")
    with pytest.raises(ValueError):
        mgr.restore_latest()
    with pytest.raises(NotImplementedError, match="local"):
        CheckpointManager("gs://bucket/ckpt")


# ------------------------------------------------------------ trainers


def _options(tmp_path, **kw):
    return TrainerOptions(num_epochs=1, save_every_epochs=1, seed=7,
                          checkpoint_dir=str(tmp_path / "ckpt"), **kw)


@pytest.mark.parametrize("stage", [1, 2])
def test_trainer_resumes_bit_equal_with_its_ema(tmp_path, capsys, stage):
    """One epoch (2 steps) with EMA on; a fresh system restored from the
    checkpoint carries the state, the optimizers and the EMA, and its
    next step with the same generator equals the unsaved system's bit for
    bit."""
    Trainer = Stage1Trainer if stage == 1 else Stage2Trainer
    system = _system(stage)
    batches = _batches(system.config, 2)
    trainer = Trainer(system, batches, _options(tmp_path, ema_decay=0.5))
    assert trainer.init_state() == 0 and trainer.ema is not None
    first_ema = {k: v.clone() for k, v in trainer.ema.items()}
    trainer.fit(0)
    assert system.step == 2
    out = capsys.readouterr().out.splitlines()
    names = ", ".join(f"stage{stage}/{k}: " for k in ("loss_critic", "loss_gen", "gp", "kl")).split(", ")
    assert [l.split(":")[0] for l in out] == ["step 0", "step 1"]
    assert all(all(n in l for n in names) for l in out)
    assert any(not torch.equal(trainer.ema[k], first_ema[k]) for k in first_ema)
    live = tema.init_ema(system, tema.modules_for_stage(stage))
    assert any(not torch.equal(trainer.ema[k], live[k]) for k in live)  # the average lags

    fresh = _system(stage, seed=99)
    trainer2 = Trainer(fresh, batches, _options(tmp_path, ema_decay=0.5))
    assert trainer2.init_state() == 1
    assert capsys.readouterr().out.strip() == "Loaded checkpoint at epoch 0"
    assert fresh.step == 2
    _flat_equal(convert.to_numpy(fresh), convert.to_numpy(system))
    assert set(trainer2.ema) == set(trainer.ema)
    for k, v in trainer.ema.items():
        assert torch.equal(trainer2.ema[k], v), k
    trainer2.fit(1)  # num_epochs reached: no step
    assert fresh.step == 2 and capsys.readouterr().out == ""

    kw = dict(host_generator=mixed_generator(7, 2, "cpu")) if stage == 1 else {}
    kw2 = dict(host_generator=mixed_generator(7, 2, "cpu")) if stage == 1 else {}
    a = system.train_step(batches[0], generator=mixed_generator(7, 2, "cpu"), **kw)
    b = fresh.train_step(batches[0], generator=mixed_generator(7, 2, "cpu"), **kw2)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    _flat_equal(convert.to_numpy(fresh), convert.to_numpy(system))

    # a run without EMA reads the composite checkpoint's live state; a run
    # with EMA on a plain checkpoint starts its average from the restored
    # parameters
    plain = Trainer(_system(stage, seed=5), batches, _options(tmp_path))
    assert plain.init_state() == 1 and plain.ema is None
    other = tmp_path / "plain"
    plain.opt.checkpoint_dir = None
    saver = Trainer(plain.system, batches, TrainerOptions(num_epochs=1, save_every_epochs=1,
                                                          checkpoint_dir=str(other)))
    saver._save(0)
    upgraded = Trainer(_system(stage, seed=6), batches,
                       TrainerOptions(checkpoint_dir=str(other), ema_decay=0.9))
    assert upgraded.init_state() == 1
    want = tema.init_ema(plain.system, tema.modules_for_stage(stage))
    for k, v in want.items():
        assert torch.equal(upgraded.ema[k], v), k


def test_trainer_steps_draw_from_the_seed_and_the_global_step(tmp_path):
    """Two trainers with one seed take the same steps; the generator of a
    step depends on the seed and the step alone."""
    runs = []
    for _ in range(2):
        system = _system(2)
        Stage2Trainer(system, _batches(system.config, 2), TrainerOptions(num_epochs=1, seed=3)).fit()
        runs.append(convert.to_numpy(system))
    _flat_equal(*runs)
    other = _system(2)
    Stage2Trainer(other, _batches(other.config, 2), TrainerOptions(num_epochs=1, seed=4)).fit()
    assert any(not np.array_equal(runs[0][k], v) for k, v in convert.to_numpy(other).items())
    a, b = (torch.randn(4, generator=mixed_generator(s, g, "cpu")) for s, g in ((3, 1), (3, 1)))
    assert torch.equal(a, b)
    draws = {tuple(torch.randn(2, generator=mixed_generator(s, g, "cpu")).tolist())
             for s in (0, 1, 2**32, 2**32 + 1) for g in (0, 1, 2**32)}
    assert len(draws) == 12  # seeds that differ above bit 32 differ too


def test_stage2_trainer_takes_stage1_and_writes_sample_grids(tmp_path):
    s1 = _system(1, seed=3)
    system = _system(2)
    batches = _batches(system.config, 3)
    trainer = Stage2Trainer(system, batches, TrainerOptions(num_epochs=1, sample_every_steps=1, seed=1))
    assert trainer.init_state(s1) == 0
    assert torch.equal(system.gen_1.UpBlock_0.ConvTranspose2d_0.weight, s1.generator.UpBlock_0.ConvTranspose2d_0.weight)
    assert torch.equal(system.encoder.embeddings.word_embeddings.weight, s1.encoder.embeddings.word_embeddings.weight)
    images = []
    trainer.writer.images = lambda step, tag, imgs: images.append((step, tag, np.asarray(imgs)))
    trainer.fit()
    r = system.config.resolution
    assert [(s, t) for s, t, _ in images] == [(1, "fake_256"), (1, "real_256"), (2, "fake_256"), (2, "real_256")]
    for _, tag, imgs in images:
        assert imgs.shape == (B, r, r, 3) and imgs.dtype == np.float32
        assert np.isfinite(imgs).all() and imgs.min() >= -1 and imgs.max() <= 1
    # the grid's noise is fixed (seed 456): equal to a sample drawn so
    want = system.sample(batches[2], generator=torch.Generator().manual_seed(456))
    assert want.shape == images[2][2].shape


# ------------------------------------------------ port checkpoint -> JAX


def test_port_checkpoint_loads_into_jax_and_the_step_continues(tmp_path):
    """Two port steps through the trainer, saved; the checkpoint's flat
    dict rebuilds a JAX ``Stage2State`` (optimizer state and step
    included), from which the JAX step reaches what the port's next step
    reaches."""
    system = _system(2)
    batches = _batches(system.config, 2)
    Stage2Trainer(system, batches, _options(tmp_path, ema_decay=0.9)).fit()
    flat, aux, start = CheckpointManager(str(tmp_path / "ckpt")).restore_latest_with_aux()
    assert start == 1 and int(flat["step"]) == 2 and int(flat["opt_state/critic/count"]) == 4
    assert aux and all(k.startswith(("ema/con_augment_2/", "ema/generator/")) for k in aux)

    jsys = js2.Stage2System(js2.Stage2Config.tiny(n_critic=2))
    template = jax.jit(jsys.init, static_argnums=1)(jax.random.key(0), B)
    state = jax_state_from_flat(template, flat, FIELDS)
    want_tree = jax.tree.map(lambda a: (a.shape, a.dtype), template)
    assert jax.tree.map(lambda a: (a.shape, a.dtype), state) == want_tree
    # the EMA side dict has the shape of the JAX package's EMA tree
    ema_tree = traverse_util.unflatten_dict({tuple(k[len("ema/"):].split("/")): v for k, v in aux.items()})
    jax_ema = jema.init_ema(state.params, jema.STAGE2_MODULES)
    assert jax.tree.map(np.shape, ema_tree) == jax.tree.map(np.shape, jax_ema)

    batch = batches[0]
    key = jax.random.key(31)
    noise = jax_noise(jsys, state, key)
    new_state, want = js2.make_train_step(jsys, donate=False)(
        state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, key)
    restored = convert.stage2_from_numpy(flat, system.config, "cpu")
    got = restored.train_step(batch, noise=noise)
    _metrics_close(got, want, "port checkpoint -> jax")
    assert_state_close(restored, new_state, system.config, "port checkpoint -> jax", FIELDS)
    assert int(new_state.step) == restored.step == 3
