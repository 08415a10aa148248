"""Tensor parallelism (``parallel/mesh.py``, ``parallel/tp.py``,
``Stage1System.shard``) on the CPU: gloo ranks on a (data, model) grid of
(1, 2) and (2, 2) against the JAX package's meshless ``make_train_step``
on the whole batch, which is what JAX's GSPMD 2-D step computes
(``tests/test_tp.py``), at the single-process files' tiny config and
tolerances (``tests/test_torch_stage1_step.py``: metrics and BatchNorm
statistics rtol = atol = 1e-4, moments and parameters by
``assert_state_close``), over two steps.

Cases: the einsum route with text dropout off at (1, 2) and (2, 2), and
the fused-attention route with text dropout on at (2, 2). With dropout
on, the JAX step's hidden dropout masks (threefry) and the fused
kernel's seeds are read from an eager forward of the JAX encoder under
the step's dropout key (``jax_text_draws``) and replayed into the ranks
(``noise['text_masks']``, ``noise['attn_seeds']``); each rank keeps its
rows of each mask and folds its row and head offsets into each seed, so
its kernel draws its part of the whole batch's attention mask.

The ranks are this file run as a script (``python tests/test_torch_tp.py
RANK WORLD PORTS INPUTS OUT DATA``), two and four of them, one thread
each. Rank 0 gathers the whole state (``convert.to_numpy``) after each
step; after the first, every rank cuts its slices from that dict again,
as a resume does, and must find its own parameters, statistics and Adam
moments bit for bit. Every rank also writes its own tensors, so the test
sees that data peers hold the same shards and the same BatchNorm
statistics (synchronised over the data group) and that model peers hold
the same whole tensors. The ranks of the two-rank group then run
``train.cli --multihost --tp 2`` twice (train, resume); its checkpoint
loads into one process of the port, and goes back to Orbax through
``tools/jax_checkpoint_to_port.py`` for a JAX trainer to resume."""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4  # the global batch of tests/test_torch_stage1_step.py
SEEDS = (11, 12)
TP = 2
CASES = {
    # name: (world, fused route with text dropout on)
    "grid12": (2, False),
    "grid22": (4, False),
    "grid22_fused_dropout": (4, True),
}


# ------------------------------------------------------------------ shared
def _configs(fused_dropout):
    from imagegenerator_tpu.models.bert import BertConfig as JBertConfig
    from imagegenerator_tpu.train import stage1 as js1
    from imagegenerator_tpu_torch.models.bert import BertConfig
    from imagegenerator_tpu_torch.train import stage1 as ts1

    extra = dict(fused_attention=fused_dropout, fused_ln=fused_dropout)
    kw = dict(n_critic=2, text_dropout=fused_dropout)
    return (js1.Stage1Config.tiny(bert=dataclasses.replace(JBertConfig.tiny(), **extra), **kw),
            ts1.Stage1Config.tiny(bert=dataclasses.replace(BertConfig.tiny(), **extra), **kw))


def _sub(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


# ------------------------------------------------------------------ worker
def _steps(rank, world, data, out):
    from imagegenerator_tpu_torch import convert
    from imagegenerator_tpu_torch.parallel import mesh

    grid = mesh.make_grid(TP)
    assert (grid.data, grid.model) == (world // TP, TP)
    b = mesh.local_batch_size(B, grid)
    rows = slice(grid.data_index * b, (grid.data_index + 1) * b)
    for case, (case_world, fused_dropout) in CASES.items():
        if case_world != world:
            continue
        _, cfg = _configs(fused_dropout)
        port = convert.stage1_from_numpy(_sub(data, f"{case}/state/"), cfg, "cpu")
        port.shard(grid)
        batch = {k: torch.from_numpy(v[rows]) for k, v in _sub(data, f"{case}/batch/").items()}
        for step in (1, 2):
            raw = _sub(data, f"{case}/noise{step}/")
            noise = {k: torch.from_numpy(v) for k, v in raw.items() if "/" not in k and k != "attn_seeds"}
            masks = _sub(raw, "text_masks/")
            if masks:
                noise["text_masks"] = [torch.from_numpy(masks[str(i)]) for i in range(len(masks))]
                noise["attn_seeds"] = [int(s) for s in raw["attn_seeds"]]
            metrics = port.train_step(batch, noise=noise, reduce=mesh.data_mean(grid))
            flat = convert.to_numpy(port)  # a collective: every rank gathers
            own = {k: v.detach().numpy() for k, v in port.state_dict().items()}
            if step == 1:  # a resume: the gathered dict cut again holds this rank's slices and moments
                again = convert.stage1_from_numpy(flat, cfg, "cpu")
                again.shard(grid)
                _assert_same_rank_state(port, again)
            np.savez(os.path.join(out, f"{case}_rank{rank}_step{step}.npz"),
                     **{f"metric/{k}": v.numpy() for k, v in metrics.items()},
                     **{f"own/{k}": v for k, v in own.items()},
                     **({f"flat/{k}": v for k, v in flat.items()} if rank == 0 else {}))


def _assert_same_rank_state(a, b) -> None:
    """Two systems on a grid hold the same slices, statistics and Adam
    state (moments cut like their parameters), bit for bit."""
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    for m in a.optimizers:
        oa, ob = a.optimizers[m], b.optimizers[m]
        for pa, pb in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            ta, tb = oa.state.get(pa, {}), ob.state.get(pb, {})
            assert ta.keys() == tb.keys(), m
            assert all(torch.equal(ta[k], tb[k]) for k in ta), m


def worker(rank: int, world: int, ports: list, inputs: str, out: str, data_dir: str) -> None:
    import torch.distributed as dist

    from imagegenerator_tpu_torch.parallel import dp
    from imagegenerator_tpu_torch.train import cli

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ports[0]))
    dp.init_from_env("cpu")
    with np.load(inputs) as f:
        data = {k: f[k] for k in f.files}
    _steps(rank, world, data, out)
    dist.destroy_process_group()
    if world != 2:
        return
    argv = ["--multihost", "--tp", "2", "--stage", "1", "--tiny", "--device", "cpu", "--data", data_dir,
            "--root", "imgs", "--ann_file", "ann/captions.json", "--batch_size", "2", "--num_epochs", "1",
            "--n_critic", "1", "--seq_len", "8", "--checkpoint_dir", os.path.join(out, "ckpt"),
            "--fused_attn", "--fused_ln", "--ema", "0.9"]
    for run in (1, 2):
        print(f"=== cli run {run}", flush=True)
        os.environ["MASTER_PORT"] = str(ports[run])
        cli.main(argv)


# ------------------------------------------------------------------ parent
def jax_text_draws(system, state, batch, key):
    """The hoisted text forward's dropout in the JAX step under ``key``
    (``stage1.py``: ``k_drop_hoist = fold_in(k_loop, n_critic)`` over the
    doubled batch): every ``nn.Dropout`` keep mask in call order, read
    from an eager forward of the encoder, and the fused attention's
    int32 seeds, one per layer."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    import imagegenerator_tpu.ops.pallas.attention as fattn

    c = system.config
    k_perm, k_loop = jax.random.split(key)
    perm = jax.random.permutation(k_perm, B)
    tokens, mask = jnp.asarray(batch["input_ids"]), jnp.asarray(batch["attention_mask"])
    masks, seeds = [], []

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout):
            masks.append(np.asarray((out != 0) | (args[0] == 0)))
        return out

    plain = fattn.fused_attention

    def record(q, k, v, m, seed, **kw):
        seeds.append(int(np.asarray(seed)[0]))
        return plain(q, k, v, m, seed, **kw)

    fattn.fused_attention = record
    try:
        with nn.intercept_methods(intercept):
            system.encoder.apply({"params": state.params["encoder"]},
                                 jnp.concatenate([tokens, tokens[perm]]), jnp.concatenate([mask, mask[perm]]),
                                 deterministic=False,
                                 rngs={"dropout": jax.random.fold_in(k_loop, c.n_critic)})
    finally:
        fattn.fused_attention = plain
    return masks, np.asarray(seeds, np.int64)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_side():
    import jax

    from imagegenerator_tpu.train import stage1 as js1
    from tests import test_torch_stage1_step as t1

    out = {}
    for case, (_, fused_dropout) in CASES.items():
        jcfg, tcfg = _configs(fused_dropout)
        system = js1.Stage1System(jcfg)
        state = jax.jit(system.init, static_argnums=1)(jax.random.key(0), B)
        out[case] = dict(system=system, state=state, tcfg=tcfg, batch=t1._batch(tcfg, fused_dropout),
                         step=js1.make_train_step(system, donate=False))
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    import jax

    from tests.test_torch_dp import _dataset
    from tests.test_torch_stage1_step import _noise, jax_flat

    tmp = tmp_path_factory.mktemp("tp")
    arrays = {}
    for case, side in jax_side.items():
        arrays.update({f"{case}/state/{k}": v for k, v in jax_flat(side["state"]).items()})
        arrays.update({f"{case}/batch/{k}": v for k, v in side["batch"].items()})
        for step, seed in enumerate(SEEDS, 1):
            key = jax.random.key(seed)
            # the draws depend on the state's structure only, not its values
            noise = {k: v.numpy() for k, v in _noise(side["system"], side["state"], key).items()}
            if CASES[case][1]:
                masks, seeds = jax_text_draws(side["system"], side["state"], side["batch"], key)
                noise.update({f"text_masks/{i}": m for i, m in enumerate(masks)}, attn_seeds=seeds)
            arrays.update({f"{case}/noise{step}/{k}": v for k, v in noise.items()})
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **arrays)
    data = str(tmp / "ds")
    _dataset(data)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    procs, logs = [], {}
    try:
        for world in (2, 4):
            ports = ",".join(str(_free_port()) for _ in range(3))
            out = tmp / f"world{world}"
            out.mkdir()
            for r in range(world):
                path = out / f"rank{r}.log"
                logs[world, r] = path
                with open(path, "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__), str(r), str(world), ports, inputs, str(out),
                         data], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env))
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = {k: path.read_text() for k, path in logs.items()}
    for (world, r), p in zip(logs, procs):
        assert p.returncode == 0, f"world {world} rank {r} failed:\n{texts[world, r][-4000:]}"
    return tmp, texts


def _load(tmp, case, rank, step):
    world = CASES[case][0]
    with np.load(tmp / f"world{world}" / f"{case}_rank{rank}_step{step}.npz") as f:
        return {k: f[k] for k in f.files}


# ------------------------------------------------------------------- tests
def test_rules_match_the_jax_rules():
    """``tp.shard_dim`` on the port's names gives JAX ``_spec_for`` on the
    flax paths (torch weight ``(out, in)`` against flax kernel ``(in,
    out)``), for BERT and both CLIP towers; ``shard_model`` slices what
    the rule names and nothing else."""
    from jax.sharding import PartitionSpec as P

    from imagegenerator_tpu.parallel.tp import _spec_for
    from imagegenerator_tpu_torch import convert
    from imagegenerator_tpu_torch.models.bert import BertConfig, BertEncoder
    from imagegenerator_tpu_torch.parallel import tp
    from imagegenerator_tpu_torch.v2.clip import CLIPConfig

    def expected(path, layout):
        spec = _spec_for(tuple(path))
        if spec == P():
            return None
        if layout == "dense":  # a kernel: flax (in, out), torch (out, in)
            return {P(None, "model"): 0, P("model", None): 1}[spec]
        return {P("model"): 0}[spec]

    bert = BertEncoder(BertConfig.tiny(), device="meta")
    bert_entries = convert.entries(bert)
    seen = set()
    for key, flat_key, layout in bert_entries:
        want = expected(flat_key.split("/")[1:], layout)
        assert tp.shard_dim(key) == want, (key, flat_key)
        seen.add(want)
    assert seen == {None, 0, 1}
    for key, path, layout in convert._clip_entries(CLIPConfig.tiny()):
        assert tp.shard_dim(key) == expected(path, layout), (key, path)
    bert.shard_model(tp.ModelShard(1, 2))
    sliced = tp.sharded_keys(bert)
    assert sliced and {k: d for k, (d, _) in sliced.items()} == {
        k: tp.shard_dim(k) for k, _, _ in bert_entries if tp.shard_dim(k) is not None}


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 5, -2**31 + 3])
def test_a_shards_folded_seed_draws_its_slice_of_the_mask(seed):
    """The kernel's keep mask is a counter hash of ``seed + row * 1000003
    + head * 7919``: a shard of rows [r0, r0 + b) and heads [h0, h0 + k)
    with the offsets folded into its seed draws exactly its slice of the
    whole batch's mask."""
    from imagegenerator_tpu_torch.models.bert import _fold_seed
    from imagegenerator_tpu_torch.ops.kernels.attention import keep_mask

    whole = keep_mask(6, 4, 8, seed, 0.3)
    for r0, b, h0, k in ((0, 3, 0, 2), (3, 3, 2, 2), (2, 2, 1, 3), (5, 1, 3, 1)):
        part = keep_mask(b, k, 8, _fold_seed(seed, r0, h0), 0.3)
        assert torch.equal(part, whole[r0:r0 + b, h0:h0 + k]), (r0, h0)


@pytest.mark.parametrize("case", list(CASES))
def test_grid_step_matches_the_jax_meshless_step(case, jax_side, ranks):
    import jax
    import jax.numpy as jnp

    from imagegenerator_tpu_torch import convert
    from tests.test_torch_stage1_step import _metrics_close, assert_state_close, jax_state_from_flat

    tmp, _ = ranks
    side = jax_side[case]
    world = CASES[case][0]
    jbatch = {k: jnp.asarray(v) for k, v in side["batch"].items()}
    state = side["state"]
    for step, seed in enumerate(SEEDS, 1):
        got = [_load(tmp, case, r, step) for r in range(world)]
        flat = _sub(got[0], "flat/")
        if step > 1:  # from the port's state after the first step
            state = jax_state_from_flat(state, _sub(_load(tmp, case, 0, 1), "flat/"))
        state, want = side["step"](state, jbatch, jax.random.key(seed))
        what = f"{case} step {step}"
        _metrics_close(_sub(got[0], "metric/"), want, what)
        assert_state_close(convert.stage1_from_numpy(flat, side["tcfg"], "cpu"), state, side["tcfg"], what)
        own = [_sub(g, "own/") for g in got]
        for r in range(1, world):
            model_peer, data_peer = r // TP == 0, r % TP == 0
            differ = {k for k in own[0] if own[0][k].shape != own[r][k].shape
                      or not np.array_equal(own[0][k], own[r][k])}
            if data_peer:  # the same slices, the same synchronised statistics
                assert not differ, (what, r, sorted(differ)[:4])
            if model_peer:  # other slices of the split weights, every whole tensor equal
                assert differ and all("encoder." in k and "LayerNorm" not in k for k in differ), (what, r)
            if world == 4 and not model_peer:
                assert not [k for k in differ if k.endswith(("running_mean", "running_var"))], (what, r)


def test_the_tp_cli_trains_resumes_and_its_checkpoint_loads_anywhere(jax_side, ranks):
    """``train.cli --multihost --tp 2``: both ranks join a (1, 2) grid,
    rank 0 logs the steps and writes the checkpoint, both resume; the
    checkpoint is the whole flat dict and loads into one process of the
    port; the checkpoint bridge carries it to Orbax, from which a JAX
    trainer resumes and trains on."""
    import jax

    from imagegenerator_tpu.train import stage1 as js1
    from imagegenerator_tpu_torch import convert
    from imagegenerator_tpu_torch.checkpoint import CheckpointManager
    from imagegenerator_tpu_torch.models.bert import BertConfig
    from imagegenerator_tpu_torch.train import stage1 as ts1
    from flax import traverse_util

    from imagegenerator_tpu.train.trainer import Stage1Trainer as JStage1Trainer
    from imagegenerator_tpu.train.trainer import TrainerOptions as JTrainerOptions
    from tests import test_torch_stage1_step as t1
    from tests.test_torch_checkpoint_bridge import bridge

    tmp, logs = ranks
    for r in range(2):
        log = logs[2, r]
        assert f"[tp] rank {r} of 2: data index 0 of 1, model index {r} of 2" in log
        first, second = log.split("=== cli run 1")[1].split("=== cli run 2")
        assert len([l for l in first.splitlines() if l.startswith("step ")]) == (4 if r == 0 else 0)
        assert "Loaded checkpoint at epoch 0" in second and "step " not in second
    flat, aux, start = CheckpointManager(str(tmp / "world2" / "ckpt" / "Stage1")).restore_latest_with_aux()
    assert start == 1 and int(flat["step"]) == 4 and any(k.startswith("ema/") for k in aux)
    bert = dataclasses.replace(BertConfig.tiny(), fused_attention=True, fused_ln=True)
    cfg = ts1.Stage1Config.tiny(n_critic=1, bert=bert)
    one = convert.stage1_from_numpy(flat, cfg, "cpu")
    assert one.step == 4
    np.testing.assert_array_equal(convert.to_numpy(one)["params/encoder/layer_0/attention/query/kernel"],
                                  flat["params/encoder/layer_0/attention/query/kernel"])
    # back to Orbax through the bridge, and a JAX trainer resumes from it
    # with the whole state and EMA, then trains on
    bridge.main(["--to", "jax", "--stage", "1", "--tiny", "--n_critic", "1", "--seq_len", "8", "--fused_attn",
                 "--fused_ln", "--checkpoint_dir", str(tmp / "world2" / "ckpt"), "--out_dir", str(tmp / "jax")])
    jsys = js1.Stage1System(js1.Stage1Config.tiny(n_critic=1))
    batch = {k: jax.numpy.asarray(v) for k, v in t1._batch(cfg, False).items()}
    trainer = JStage1Trainer(jsys, [batch], JTrainerOptions(num_epochs=2, checkpoint_dir=str(tmp / "jax" / "Stage1"),
                                                            ema_decay=0.9))
    jstate, jstart = trainer.init_state(2)
    assert jstart == 1 and int(jstate.step) == 4
    restored = bridge.jax_flat(jstate)
    assert set(restored) == set(flat) and all(np.array_equal(restored[k], v) for k, v in flat.items())
    ema = traverse_util.flatten_dict(trainer.ema, sep="/")
    assert {f"ema/{k}" for k in ema} == set(aux) and all(np.array_equal(v, aux[f"ema/{k}"]) for k, v in ema.items())
    jstate = trainer.fit(jstate, jstart)
    assert int(jstate.step) == 5
    assert np.isfinite(np.asarray(jstate.params["encoder"]["layer_0"]["attention"]["query"]["kernel"])).all()


if __name__ == "__main__":
    r, world, ports, inp, out_dir, ds = sys.argv[1:]
    worker(int(r), int(world), [int(p) for p in ports.split(",")], inp, out_dir, ds)
