"""The port's training CLI end to end on the CPU at the tiny configs:
train stage 1 -> train stage 2 on its checkpoint -> sample, through
``train.cli`` and ``train.sample`` as a user calls them; the resume
contract (``Loaded checkpoint at epoch N``, no step taken again); the EMA
side dict and ``--ema``; the flags that are not ported exit with their
messages. Against the JAX CLI over the same dataset the run is held in
structure (step count, metric names, saved epochs), not draw for draw:
the two packages' generators differ."""

import json
import os
import re

import numpy as np
import pytest
import torch

from imagegenerator_tpu_torch.checkpoint import CheckpointManager
from imagegenerator_tpu_torch.models.bert import BertConfig, BertEncoder
from imagegenerator_tpu_torch.train import cli, sample
from imagegenerator_tpu_torch.train import trainer as trainer_mod
from imagegenerator_tpu_torch.utils.png import decode_png, write_png

torch.set_num_threads(2)
STEP = re.compile(r"^step (\d+): (.*)$")


def _dataset(root, n=4):
    rng = np.random.default_rng(0)
    os.makedirs(root / "imgs")
    os.makedirs(root / "ann")
    images, anns = [], []
    for i in range(n):
        write_png(str(root / "imgs" / f"img{i}.png"), rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
        images.append({"id": i, "file_name": f"img{i}.png"})
        anns.append({"image_id": i, "caption": f"synthetic caption {i}"})
    (root / "ann" / "captions.json").write_text(json.dumps({"images": images, "annotations": anns}))
    return str(root)


def _args(data, ckpt, stage, *extra):
    return ["--stage", str(stage), "--tiny", "--device", "cpu", "--data", data, "--root", "imgs",
            "--ann_file", "ann/captions.json", "--batch_size", "2", "--num_epochs", "1",
            "--n_critic", "1", "--seq_len", "8", "--checkpoint_dir", ckpt, *extra]


def _steps(out):
    """[(step, [metric names])] of the ``step N: name: value, ...`` lines."""
    found = []
    for line in out.splitlines():
        m = STEP.match(line)
        if m:
            found.append((int(m.group(1)), [part.split(":")[0].strip() for part in m.group(2).split(",")]))
    return found


def _tree(path):
    return sorted(os.path.relpath(os.path.join(d, f), path) for d, _, files in os.walk(path) for f in files)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Stage 1 (twice), stage 2 on its checkpoint (twice), with EMA on and
    the BERT kernels' flags; what each run printed."""
    tmp = tmp_path_factory.mktemp("chain")
    data, ckpt = _dataset(tmp / "ds"), str(tmp / "ckpt")
    outs = {}
    import contextlib
    import io

    def run(name, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        outs[name] = buf.getvalue()

    flags = ("--ema", "0.9", "--fused_attn", "--fused_ln")
    run("stage1", _args(data, ckpt, 1, *flags))
    run("stage1_again", _args(data, ckpt, 1, *flags))
    s2 = ("--stage1_checkpoint", os.path.join(ckpt, "Stage1"))
    run("stage2", _args(data, ckpt, 2, *flags, *s2))
    run("stage2_again", _args(data, ckpt, 2, *flags, *s2))
    return tmp, data, ckpt, outs


@pytest.mark.parametrize("stage", [1, 2])
def test_cli_trains_saves_and_resumes(chain, stage):
    _, _, ckpt, outs = chain
    names = [f"stage{stage}/{k}" for k in ("gp", "kl", "loss_critic", "loss_gen")]
    assert _steps(outs[f"stage{stage}"]) == [(0, names), (1, names)]  # 4 captions / batch 2
    assert "Loaded checkpoint" not in outs[f"stage{stage}"]
    values = [float(v) for v in re.findall(r": (-?[\d.]+(?:e-?\d+)?|nan|inf)", outs[f"stage{stage}"])]
    assert len(values) == 8 and np.isfinite(values).all()
    # the second run resumes after the saved epoch and takes no step
    assert outs[f"stage{stage}_again"].strip() == "Loaded checkpoint at epoch 0"
    stage_dir = os.path.join(ckpt, f"Stage{stage}")
    assert _tree(stage_dir) == ["LATEST_EPOCH", "epochs/checkpoint_epoch_0/state.npz", "latest/state.npz"]
    flat, aux, start = CheckpointManager(stage_dir).restore_latest_with_aux()
    assert start == 1 and int(flat["step"]) == 2
    modules = ("con_augment_2", "generator") if stage == 2 else ("encoder", "projection", "con_augment", "generator")
    assert {k.split("/")[1] for k in aux} == set(modules) and all(k.startswith("ema/") for k in aux)
    assert int(flat["opt_state/critic/count"]) == 2


def test_stage2_froze_the_stage1_checkpoint(chain):
    _, _, ckpt, _ = chain
    s1, _ = CheckpointManager(os.path.join(ckpt, "Stage1")).restore_latest()
    s2, _ = CheckpointManager(os.path.join(ckpt, "Stage2")).restore_latest()
    pairs = {"params/encoder/": "frozen_params/encoder/", "params/projection/": "frozen_params/projection/",
             "params/con_augment/": "frozen_params/con_augment_1/", "params/generator/": "frozen_params/gen_1/",
             "batch_stats/generator/": "frozen_gen_stats/"}
    seen = 0
    for k, v in s1.items():
        for src, dst in pairs.items():
            if k.startswith(src):
                assert np.array_equal(s2[dst + k[len(src):]], v), k
                seen += 1
    assert seen == sum(k.startswith(("frozen_params/", "frozen_gen_stats/")) for k in s2) > 20


@pytest.mark.parametrize("stage", [1, 2])
def test_sample_cli_reads_the_training_checkpoint(chain, capsys, stage):
    tmp, _, ckpt, _ = chain
    res = 16 if stage == 1 else 32
    images = {}
    for tag, extra in (("live", []), ("ema", ["--ema"])):
        out = tmp / f"samples{stage}_{tag}"
        sample.main(["--stage", str(stage), "--tiny", "--device", "cpu", "--checkpoint_dir", ckpt,
                     "--caption", "a red bus|a snowy street", "-n", "2", "-o", str(out), "--seed", "3",
                     "--fused_attn", "--fused_ln", *extra])
        printed = capsys.readouterr().out
        assert printed.startswith("Loaded checkpoint at epoch 0\n")
        assert f"wrote {out / 'sample_1_1.png'} ({res}x{res}): a snowy street" in printed
        files = sorted(p.name for p in out.iterdir())
        assert files == ["sample_0_0.png", "sample_0_1.png", "sample_1_0.png", "sample_1_1.png"]
        data = (out / "sample_1_0.png").read_bytes()
        assert b"tEXtcomment\0a snowy street" in data
        images[tag] = decode_png(data)
        assert images[tag].shape == (res, res, 3)
    assert not np.array_equal(images["live"], images["ema"])  # the averages lag the live weights


def test_sample_ema_needs_an_ema_run(tmp_path, capsys):
    data, ckpt = _dataset(tmp_path / "ds"), str(tmp_path / "ckpt")
    cli.main(_args(data, ckpt, 1))  # no --ema
    capsys.readouterr()
    base = ["--stage", "1", "--tiny", "--device", "cpu", "--checkpoint_dir", ckpt, "--caption", "x",
            "-o", str(tmp_path / "out")]
    with pytest.raises(SystemExit, match="no EMA side tree"):
        sample.main(base + ["--ema"])
    sample.main(base)
    assert "Loaded checkpoint at epoch 0" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no checkpoint found"):
        sample.main(base[:1] + ["2"] + base[2:])


@pytest.mark.parametrize("flags, message", [
    (["--tp", "2", "--stage", "2"], "--tp applies to stage 1 (the in-step BERT)"),
    (["--tp", "2"], "--tp 2 does not divide 1 devices"),
])
def test_cli_tp_usage_errors(tmp_path, flags, message):
    """The JAX CLI's messages; ``--tp`` itself runs under torchrun
    (``tests/test_torch_tp.py``)."""
    with pytest.raises(SystemExit, match=re.escape(message)):
        cli.main(_args(str(tmp_path), str(tmp_path / "ckpt"), 1, *flags))
    assert not (tmp_path / "ckpt").exists()


def test_cli_profile_dir_writes_a_trace_of_the_training_loop(tmp_path, capsys):
    prof = tmp_path / "prof"
    cli.main(_args(_dataset(tmp_path / "ds"), str(tmp_path / "ckpt"), 1, "--profile_dir", str(prof)))
    out = capsys.readouterr().out
    assert len(_steps(out)) == 2 and f"[profile] trace written to {prof / 'trace_rank0.json'}" in out
    assert os.listdir(prof) == ["trace_rank0.json"]
    events = json.loads((prof / "trace_rank0.json").read_text())["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"data", "train_step", "critic"} <= spans


def test_cli_multihost_runs_as_one_rank_over_gloo(tmp_path, capsys, monkeypatch):
    """``--multihost`` in torchrun's environment at world size 1 on the
    CPU: the process group is joined (gloo), the run trains and saves as
    the plain run does, and the group is left at the end."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ckpt = tmp_path / "ckpt"
    cli.main(_args(_dataset(tmp_path / "ds"), str(ckpt), 1, "--multihost"))
    out = capsys.readouterr().out
    assert "[dp] rank 0 of 1 (local 0 of 1) on cpu: backend gloo (the CPU)" in out
    assert len(_steps(out)) == 2 and not dist.is_initialized()
    assert _tree(ckpt / "Stage1") == ["LATEST_EPOCH", "epochs/checkpoint_epoch_0/state.npz", "latest/state.npz"]
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(SystemExit, match="torchrun's environment; missing \\['MASTER_PORT'\\]"):
        cli.main(_args(str(tmp_path / "ds"), str(ckpt), 1, "--multihost"))


def test_cli_needs_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _args(_dataset(tmp_path / "ds"), str(tmp_path / "ckpt"), 1) if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(argv)
    with pytest.raises(SystemExit, match="--stage1_checkpoint: no checkpoint found"):
        cli.main(_args(str(tmp_path / "ds"), str(tmp_path / "ckpt"), 2, "--stage1_checkpoint", str(tmp_path / "none")))


def test_cli_flag_surface_follows_jax():
    from imagegenerator_tpu.train import cli as jcli

    def flags(parser):
        return {a.dest: (a.default, tuple(a.choices) if a.choices else None, getattr(a.type, "__name__", None))
                for a in parser._actions if a.dest != "help"}

    ours, theirs = flags(cli.get_parser()), flags(jcli.get_parser())
    assert set(theirs) - set(ours) == {"rng_impl"}
    assert set(ours) - set(theirs) == {"device"}
    for dest, spec in theirs.items():
        if dest != "rng_impl":
            assert ours[dest] == spec, dest
    assert ours["device"][0] == "cuda"
    help_text = cli.get_parser().format_help()
    assert "RngBitGenerator" not in help_text and "TPU" not in help_text


@pytest.mark.parametrize("stage", [1, 2])
def test_cli_loads_a_pretrained_encoder(tmp_path, monkeypatch, capsys, stage):
    """``--bert_checkpoint``: the architecture comes from the weights'
    shapes (under ``--tiny`` too) and a fresh run starts from them."""
    bert_cfg = BertConfig(vocab_size=50, hidden_size=64, num_layers=2, num_heads=1, intermediate_size=96,
                          max_position_embeddings=16)
    encoder = BertEncoder(bert_cfg, device="cpu", generator=torch.Generator().manual_seed(8))
    sd = {f"bert.{k}": v for k, v in encoder.state_dict().items()}
    sd["bert.pooler.dense.weight"] = torch.zeros(64, 64)
    torch.save(sd, tmp_path / "bert.bin")
    started = []
    Trainer = trainer_mod.Stage1Trainer if stage == 1 else trainer_mod.Stage2Trainer
    monkeypatch.setattr(Trainer, "fit", lambda self, start: started.append((self.system, start)))
    cli.main(_args(_dataset(tmp_path / "ds"), str(tmp_path / "ckpt"), stage,
                   "--bert_checkpoint", str(tmp_path / "bert.bin"), "--gelu", "tanh", "--dropout_bits", "16"))
    assert "Loaded pretrained BERT: 2L/64H vocab=50" in capsys.readouterr().out
    (system, start), = started
    assert start == 0 and system.config.seq_len == 8
    got = system.config.bert
    assert (got.num_layers, got.hidden_size, got.vocab_size, got.max_position_embeddings) == (2, 64, 50, 16)
    assert got.gelu_approximate and got.dropout_bits == 16 and not got.fused_attention
    for k, v in encoder.state_dict().items():
        assert torch.equal(system.encoder.state_dict()[k], v), k


def test_run_has_the_structure_of_the_jax_trainer_run(chain, tmp_path, capsys, monkeypatch):
    """The JAX package's trainer on the same dataset, batch size and
    options as the CLI run above (its CLI would spread the batch over the
    8 virtual CPU devices the tests run under): the same steps, the same metric
    names in the same order, the same saved epoch, the same resume
    line."""
    from imagegenerator_tpu import data as jdata
    from imagegenerator_tpu.data import native as jnative
    from imagegenerator_tpu.train import stage1 as js1
    from imagegenerator_tpu.train import trainer as jtrainer

    monkeypatch.setattr(jnative, "available", lambda: False)
    _, data, ckpt, outs = chain
    cfg = js1.Stage1Config.tiny(n_critic=1)
    ds = jdata.CocoCaptions(jdata.open_store(data), "imgs", "ann/captions.json", image_size=cfg.resolution)
    tok = jdata.HashTokenizer(vocab_size=cfg.bert.vocab_size, max_length=cfg.seq_len)
    options = jtrainer.TrainerOptions(num_epochs=1, seed=42, ema_decay=0.9,
                                      checkpoint_dir=str(tmp_path / "jck" / "Stage1"))

    def run():
        loader = jdata.DataLoader(ds, tok, batch_size=2, seed=42, num_workers=2)
        trainer = jtrainer.Stage1Trainer(js1.Stage1System(cfg), loader, options)
        state, start = trainer.init_state(2)
        trainer.fit(state, start)
        return capsys.readouterr().out

    first, again = run(), run()
    assert _steps(first) == _steps(outs["stage1"])
    assert [l for l in again.splitlines() if l.startswith("Loaded")] == ["Loaded checkpoint at epoch 0"]
    assert _steps(again) == _steps(outs["stage1_again"]) == []
    top = lambda path: sorted(os.listdir(path))
    assert top(tmp_path / "jck" / "Stage1") == top(os.path.join(ckpt, "Stage1")) == ["LATEST_EPOCH", "epochs", "latest"]
    assert top(tmp_path / "jck" / "Stage1" / "epochs") == top(os.path.join(ckpt, "Stage1", "epochs"))
    assert (tmp_path / "jck" / "Stage1" / "LATEST_EPOCH").read_text() == open(
        os.path.join(ckpt, "Stage1", "LATEST_EPOCH")).read()
