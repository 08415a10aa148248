"""Data parallelism (``parallel/dp.py``) on the CPU: two ranks of the port
over gloo against the JAX package's ``make_train_step(system,
make_mesh(2))`` on two of the eight virtual CPU devices, for the stage-1
and the stage-2 step over two steps, at the tiny configs of the
single-process files (``tests/test_torch_stage1_step.py``, case
``hoisted_reuse``; ``tests/test_torch_stage2_step.py``, case
``tokens_f32``) and at their tolerances (metrics and rank 0's BatchNorm
statistics rtol = atol = 1e-4; moments and parameters by
``assert_state_close``).

The global batch is the single-process files' (4); each rank takes its
half, as each JAX shard does. The JAX step hands its one key to every
shard, so both shards draw the same permutation (over the local batch)
and the same noise; both ranks replay those draws. Each step starts from
the same state on both sides: the second JAX step from rank 0's state
after the first (JAX replicates it; BatchNorm running statistics do not
enter a training-mode step, so rank 1's own ones change nothing but
themselves). After every step the ranks' parameters and optimizer states
are bit-equal and their BatchNorm statistics differ.

The two ranks are this file run as a script (``python
tests/test_torch_dp.py RANK ...``), spawned once for the module; they
also run the training CLI with ``--multihost`` over a tiny dataset (one
epoch, then the resume) with ``--profile_dir``, and check that a rank
with fewer batches than the other stops both at the start of the epoch.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
B = 4  # the global batch
LOCAL = B // WORLD
SEEDS = (11, 12)  # the two steps' keys
FIELDS2 = ("frozen_params", "frozen_gen_stats", "params", "batch_stats")


# ------------------------------------------------------------------ worker
def _npz(path, **arrays):
    np.savez(path, **arrays)


def _sub(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def _steps_worker(rank, inputs, out):
    from imagegenerator_tpu_torch import convert
    from imagegenerator_tpu_torch.parallel import dp
    from imagegenerator_tpu_torch.train import stage1 as ts1
    from imagegenerator_tpu_torch.train import stage2 as ts2

    with np.load(inputs) as f:
        data = {k: f[k] for k in f.files}
    configs = {1: (ts1.Stage1Config.tiny(n_critic=2, text_dropout=False), convert.stage1_from_numpy),
               2: (ts2.Stage2Config.tiny(n_critic=2), convert.stage2_from_numpy)}
    rows = slice(rank * LOCAL, (rank + 1) * LOCAL)
    for stage, (cfg, build) in configs.items():
        port = build(_sub(data, f"s{stage}/state/"), cfg, "cpu")
        batch = {k: torch.from_numpy(v[rows]) for k, v in _sub(data, f"s{stage}/batch/").items()}
        for step in (1, 2):
            noise = {k: torch.from_numpy(v) for k, v in _sub(data, f"s{stage}/noise{step}/").items()}
            metrics = port.train_step(batch, noise=noise, reduce=dp.all_reduce_mean)
            flat = convert.to_numpy(port)
            _npz(os.path.join(out, f"rank{rank}_s{stage}_step{step}.npz"),
                 **{f"metric/{k}": v.numpy() for k, v in metrics.items()}, **flat)


def _unequal_steps_worker(rank):
    """A rank with two batches and a rank with one: both raise at the
    epoch's start, before any step."""
    from imagegenerator_tpu_torch.data.pipeline import DataLoader

    samples = [("a caption", np.zeros((4, 4, 3), np.uint8))] * (4 if rank == 0 else 2)
    loader = DataLoader(samples, lambda caps: {"n": np.array([len(caps)])}, 2, num_workers=1, device="cpu")
    try:
        next(iter(loader))
    except RuntimeError as e:
        return str(e)
    return "no error"


def _broadcast_worker(rank):
    """``broadcast_state`` gives every rank rank 0's parameters, buffers
    and Adam state."""
    from imagegenerator_tpu_torch.parallel import dp
    from imagegenerator_tpu_torch.train import schedules

    torch.manual_seed(rank)
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    opt = schedules.adam(net.parameters(), 1e-3)
    net(torch.randn(5, 3)).sum().backward()
    opt.step()
    dp.broadcast_state([net], [opt])
    tensors = [*net.parameters(), *net.buffers(),
               *(v for s in opt.state.values() for v in s.values() if torch.is_tensor(v))]
    return [t.detach().double().sum().item() for t in tensors]


def worker(rank: int, ports: list[int], inputs: str, out: str, data: str) -> None:
    """One rank: the steps, the broadcast and the equal-steps check in one
    process group, then the CLI twice (each run joins a group of its own,
    on a port of its own)."""
    import torch.distributed as dist

    from imagegenerator_tpu_torch.parallel import dp
    from imagegenerator_tpu_torch.train import cli

    torch.set_num_threads(1)
    env = dict(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ports[0]))
    os.environ.update(env)
    dp.init_from_env("cpu")
    _steps_worker(rank, inputs, out)
    report = {"unequal": _unequal_steps_worker(rank), "broadcast": _broadcast_worker(rank)}
    dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)

    argv = ["--multihost", "--stage", "1", "--tiny", "--device", "cpu", "--data", data, "--root", "imgs",
            "--ann_file", "ann/captions.json", "--batch_size", "2", "--num_epochs", "1", "--n_critic", "1",
            "--seq_len", "8", "--checkpoint_dir", os.path.join(out, "ckpt"), "--ema", "0.9",
            "--logdir", os.path.join(out, f"logs{rank}"), "--profile_dir", os.path.join(out, "prof")]
    for run in (1, 2):
        print(f"=== cli run {run}", flush=True)
        os.environ["MASTER_PORT"] = str(ports[run])
        cli.main(argv)


# ------------------------------------------------------------------ parent
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dataset(root, n=8):
    from imagegenerator_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "imgs"))
    os.makedirs(os.path.join(root, "ann"))
    images, anns = [], []
    for i in range(n):
        write_png(os.path.join(root, "imgs", f"img{i}.png"), rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
        images.append({"id": i, "file_name": f"img{i}.png"})
        anns.append({"image_id": i, "caption": f"synthetic caption {i}"})
    with open(os.path.join(root, "ann", "captions.json"), "w") as f:
        json.dump({"images": images, "annotations": anns}, f)


def _stage1_noise(system, state, key):
    """The draws of the JAX stage-1 step's key tree at the local batch
    (``tests/test_torch_stage1_step.py::_noise``)."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_sample import _eps

    c = system.config
    k_perm, k_loop = jax.random.split(key)
    noise = {"perm": jax.random.permutation(k_perm, LOCAL), "ca_eps": [], "z": [], "gp_eps": []}
    tem = jnp.zeros((LOCAL, c.tem_size))
    for it_key in jax.random.split(k_loop, c.n_critic):
        _, k_ca, k_z, k_gp = jax.random.split(it_key, 4)
        noise["ca_eps"].append(_eps(system.con_augment, state.params["con_augment"], tem, k_ca))
        noise["z"].append(jax.random.normal(k_z, (LOCAL, c.z_dim), jnp.float32))
        noise["gp_eps"].append(jax.random.uniform(k_gp, (LOCAL, 1, 1, 1), dtype=jnp.float32))
    return {k: np.array(v) for k, v in noise.items()}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX systems, initial states, batches and two-device steps."""
    import jax

    from imagegenerator_tpu.parallel import make_mesh
    from imagegenerator_tpu.train import stage1 as js1
    from imagegenerator_tpu.train import stage2 as js2
    from tests import test_torch_stage1_step as t1
    from tests import test_torch_stage2_step as t2

    mesh = make_mesh(WORLD)
    out = {}
    for stage, (mod, tmod, case) in {1: (js1, t1, "hoisted_reuse"), 2: (js2, t2, "tokens_f32")}.items():
        jcfg, tcfg = tmod._configs(tmod.CASES[case]["kw"], tmod.CASES[case]["fused"])
        system = mod.Stage1System(jcfg) if stage == 1 else mod.Stage2System(jcfg)
        state = jax.jit(system.init, static_argnums=1)(jax.random.key(0), B)
        batch = t1._batch(tcfg, False) if stage == 1 else t2._batch(tcfg, "tokens", False)
        out[stage] = dict(system=system, state=state, tcfg=tcfg, batch=batch,
                          step=mod.make_train_step(system, mesh, donate=False))
    return out


def _noise_for(stage, side, state, key):
    from tests.test_torch_stage2_step import jax_noise

    if stage == 1:
        return _stage1_noise(side["system"], state, key)
    return {k: v.numpy() for k, v in jax_noise(side["system"], state, key, n=LOCAL).items()}


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Spawn the two ranks on inputs the JAX side built; their outputs."""
    import jax

    from tests.test_torch_stage1_step import jax_flat

    tmp = tmp_path_factory.mktemp("dp")
    arrays = {}
    for stage, side in jax_side.items():
        fields = ("params", "batch_stats") if stage == 1 else FIELDS2
        arrays.update({f"s{stage}/state/{k}": v for k, v in jax_flat(side["state"], fields).items()})
        arrays.update({f"s{stage}/batch/{k}": v for k, v in side["batch"].items()})
        for step, seed in enumerate(SEEDS, 1):
            # the draws depend on the state's structure only, not its values
            noise = _noise_for(stage, side, side["state"], jax.random.key(seed))
            arrays.update({f"s{stage}/noise{step}/{k}": v for k, v in noise.items()})
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **arrays)
    data = str(tmp / "ds")
    _dataset(data)
    ports = ",".join(str(_free_port()) for _ in range(3))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    # each rank writes to a file: a full pipe would stop a rank inside a
    # collective that the other waits on
    paths = [tmp / f"rank{r}.log" for r in range(WORLD)]
    procs = []
    try:
        for r, path in enumerate(paths):
            with open(path, "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(r), ports, inputs, str(tmp), data], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env))
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [path.read_text() for path in paths]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return tmp, logs


def _load(tmp, rank, stage, step):
    with np.load(tmp / f"rank{rank}_s{stage}_step{step}.npz") as f:
        return {k: f[k] for k in f.files}


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("stage", [1, 2])
def test_two_gloo_ranks_match_jax_on_two_devices(stage, jax_side, ranks):
    from imagegenerator_tpu_torch import convert
    from tests.test_torch_stage1_step import _metrics_close, assert_state_close, jax_state_from_flat

    tmp, _ = ranks
    side = jax_side[stage]
    fields = ("params", "batch_stats") if stage == 1 else FIELDS2
    build = convert.stage1_from_numpy if stage == 1 else convert.stage2_from_numpy
    import jax
    import jax.numpy as jnp

    jbatch = {k: jnp.asarray(v) for k, v in side["batch"].items()}
    state = side["state"]
    for step, seed in enumerate(SEEDS, 1):
        got = [_load(tmp, r, stage, step) for r in range(WORLD)]
        if step > 1:  # from the port's state after the first step (rank 0's)
            state = jax_state_from_flat(state, {k: v for k, v in _load(tmp, 0, stage, 1).items()
                                                if not k.startswith("metric/")}, fields)
        state, want = side["step"](state, jbatch, jax.random.key(seed))
        what = f"stage {stage} step {step}"
        metrics = _sub(got[0], "metric/")
        _metrics_close(metrics, want, what)
        flat0 = {k: v for k, v in got[0].items() if not k.startswith("metric/")}
        assert_state_close(build(flat0, side["tcfg"], "cpu"), state, side["tcfg"], what, fields)
        # the ranks agree bit for bit on everything but BatchNorm statistics
        differ = [k for k in got[0] if not np.array_equal(got[0][k], got[1][k])]
        assert differ and all(k.startswith("batch_stats/") for k in differ), (what, differ[:5])
        for module in ("generator", "critic"):
            assert any(k.startswith(f"batch_stats/{module}/") for k in differ), (what, module)


def test_the_ranks_logged_and_ran_the_cli(ranks):
    """The rank lines, the steps (rank 0 prints them), the broadcast and
    the equal-steps check; the CLI's two runs: both ranks resume, only
    rank 0 wrote the checkpoint, one trace per rank."""
    tmp, logs = ranks
    for r, log in enumerate(logs):
        assert f"[dp] rank {r} of 2 (local {r} of 2) on cpu: backend gloo (the CPU)" in log
        first, second = log.split("=== cli run 1")[1].split("=== cli run 2")
        steps = [l for l in first.splitlines() if l.startswith("step ")]
        assert len(steps) == (2 if r == 0 else 0)  # 8 images, 4 per rank, batch 2
        assert "Loaded checkpoint at epoch 0" in second and "step " not in second
        with open(tmp / f"rank{r}.json") as f:
            report = json.load(f)
        assert "batches per epoch differ across ranks (1 to 2" in report["unequal"], report["unequal"]
        if r:
            with open(tmp / "rank0.json") as f:
                assert report["broadcast"] == json.load(f)["broadcast"]
    stage1 = tmp / "ckpt" / "Stage1"
    found = sorted(str(p.relative_to(stage1)) for p in stage1.rglob("*") if p.is_file())
    assert found == ["LATEST_EPOCH", "epochs/checkpoint_epoch_0/state.npz", "latest/state.npz"]
    with np.load(stage1 / "latest" / "state.npz") as f:
        assert int(f["state/step"]) == 2 and any(k.startswith("aux/ema/") for k in f.files)
    assert not (tmp / "logs1").exists()
    assert sorted(os.listdir(tmp / "prof")) == ["trace_rank0.json", "trace_rank1.json"]


def test_backend_for():
    from imagegenerator_tpu_torch.parallel import dp

    assert dp.backend_for("cpu", 2, 0) == "gloo"
    assert dp.backend_for("cpu", 1, 8) == "gloo"
    assert dp.backend_for("cuda", 2, 2) == "nccl"
    assert dp.backend_for("cuda", 4, 8) == "nccl"
    assert dp.backend_for("cuda", 2, 1) == "gloo"
    assert dp.backend_for("cuda", 1, 1) == "nccl"


def test_world_size_one_never_touches_torch_distributed(monkeypatch):
    import torch.distributed as dist

    from imagegenerator_tpu_torch.parallel import dp

    def forbidden(*_, **__):
        raise AssertionError("torch.distributed was called at world size 1")

    for name in ("all_reduce", "broadcast", "barrier", "get_rank", "get_world_size", "get_backend"):
        monkeypatch.setattr(dist, name, forbidden)
    assert (dp.world(), dp.rank(), dp.is_main()) == (1, 0, True)
    t = [torch.arange(4.0), torch.ones(2, dtype=torch.float64)]
    before = [x.clone() for x in t]
    dp.all_reduce_mean(t)
    assert all(torch.equal(a, b) for a, b in zip(t, before))
    dp.broadcast_state([torch.nn.Linear(2, 2)])
    dp.barrier()
    dp.check_same_on_all_ranks(3, "steps")
    assert dp.local_batch_size(8) == 8 and dp.local_batch_size(8, 2) == 4
    with pytest.raises(ValueError, match="not divisible"):
        dp.local_batch_size(6, 4)


if __name__ == "__main__":
    r, ports, inp, out_dir, ds = sys.argv[1:]
    worker(int(r), [int(p) for p in ports.split(",")], inp, out_dir, ds)
