"""The evaluation CLI and the v2 CLI over two ranks (gloo, on the CPU)
against one process on the same inputs.

The ranks are this file run as a script (``python
tests/test_torch_eval_dp.py RANK PORTS ROOT``), spawned once for the
module with ``torchrun``'s environment; each CLI run joins a process
group of its own, on a port of its own. Each rank, and the one process
it is held to, computes on one CPU thread (the thread count changes how
the CPU's kernels round). They run:

* the evaluation CLI with ``--dp 2`` on a ResNet ``.pt`` (samples from an
  ``.npz``, a reference directory, captions, ``--batch 4`` over 7 and 5
  images, so the last batches are ragged): its JSON line must equal one
  process's, the counts exactly, the numbers to 1e-5 relative (the
  embeddings are the same f32 arithmetic over fewer rows);
* the v2 CLI at batch 4 (``--prompts_file`` of 4 lines, the tiny models,
  ``-i 4 -se 2 --state``) and then its resume to 6: rank 0's loss lines
  must equal one process's (rtol 1e-4 on the printed values), its PNGs
  one process's within 1 of 255, its ``--state`` file one process's (the
  counts exactly, the latent and the Adam moments to 1e-5 relative of
  their largest), and rank 1 prints no loss line and writes no file.
"""

import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
PROMPTS = "a watercolor fox|stormy sea:0.5\nred bus\ntwo dogs:1:0.2|blurry:-0.5\na bowl of fruit\n"


def _eval_args(root):
    return ["--samples", f"{root}/samples.npz", "--ref", f"{root}/ref", "--captions", "a fox|a bus|a fox|sea|a bus|a fox|sky",
            "-m", "RN50", "--clip_checkpoint", f"{root}/rn.pt", "--batch", "4", "--device", "cpu"]


def _v2_args(root, out, iterations):
    return ["-cd", "cpu", "-sd", "3", "-s", "32", "32", "--prompts_file", f"{root}/prompts.txt",
            "-i", str(iterations), "-se", "2", "-o", f"{out}/o.png", "--state", f"{out}/s.npz"]


# ------------------------------------------------------------------ worker
def worker(rank: int, ports: list, root: str) -> None:
    from imagegenerator_tpu_torch.eval import cli
    from imagegenerator_tpu_torch.v2 import generate

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1")
    os.environ["MASTER_PORT"] = str(ports[0])
    print("=== eval", flush=True)
    result = cli.main([*_eval_args(root), "--dp", str(WORLD)])
    with open(os.path.join(root, f"eval_rank{rank}.json"), "w") as f:
        json.dump(result, f)
    for run, iterations in ((1, 4), (2, 6)):
        print(f"=== v2 run {run}", flush=True)
        os.environ["MASTER_PORT"] = str(ports[run])
        generate.main(_v2_args(root, os.path.join(root, "ranks"), iterations))


# ------------------------------------------------------------------ parent
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, one process's runs, and the two ranks' logs."""
    from imagegenerator_tpu_torch.eval import cli
    from imagegenerator_tpu_torch.utils.png import write_png
    from imagegenerator_tpu_torch.v2 import generate
    from imagegenerator_tpu_torch.v2.clip import CLIPConfig
    from tests.test_torch_clip_resnet import CONFIGS, seeded_clip_state

    root = tmp_path_factory.mktemp("eval_dp")
    sd = seeded_clip_state(CLIPConfig(**CONFIGS["1111_64px"]), seed=9)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, root / "rn.pt")
    rng = np.random.default_rng(0)
    np.savez(root / "samples.npz", images=rng.integers(0, 256, (7, 48, 48, 3), dtype=np.uint8))
    (root / "ref").mkdir()
    for i in range(5):  # another law than the samples', as a real set differs from a generated one
        blocks = rng.integers(64, 192, (5, 5, 3), dtype=np.uint8)
        write_png(str(root / "ref" / f"{i}.png"), blocks.repeat(8, 0).repeat(8, 1))
    (root / "prompts.txt").write_text(PROMPTS)
    (root / "one").mkdir()
    (root / "ranks").mkdir()

    # one process on one thread, as each rank runs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {"eval": cli.main(_eval_args(root))}
        for run, iterations in ((1, 4), (2, 6)):
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                generate.main(_v2_args(root, root / "one", iterations))
            one[run] = printed.getvalue()
            with np.load(root / "one" / "s.npz") as d:
                one[run, "state"] = {k: d[k] for k in d.files}
            one[run, "pngs"] = {p.name: p.read_bytes() for p in (root / "one").glob("*.png")}
    finally:
        torch.set_num_threads(threads)

    ports = ",".join(str(_free_port()) for _ in range(3))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # each rank writes to a file: a full pipe would stop a rank inside a
    # collective that the other waits on
    paths = [root / f"rank{r}.log" for r in range(WORLD)]
    procs = []
    try:
        for r, path in enumerate(paths):
            with open(path, "w") as log:
                procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), ports, str(root)],
                                              stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env))
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
    return root, one, logs


def test_eval_over_two_ranks_is_one_process(runs):
    root, one, logs = runs
    want = one["eval"]
    assert want["n_samples"] == 7 and want["n_ref"] == 5 and want["frechet_clip_distance"] > 1e-2
    for r in range(WORLD):
        with open(root / f"eval_rank{r}.json") as f:
            got = json.load(f)
        assert set(got) == set(want)
        for key, value in want.items():
            if isinstance(value, float):
                assert got[key] == pytest.approx(value, rel=1e-5), (r, key)
            else:
                assert got[key] == value, (r, key)
    eval_out = [log.split("=== eval")[1].split("=== v2 run 1")[0] for log in logs]
    assert f"[dp] rank 0 of {WORLD} (local 0 of {WORLD}) on cpu: backend gloo (the CPU)" in eval_out[0]
    assert [l for l in eval_out[0].splitlines() if l.startswith("{")] == [json.dumps(json.load(
        open(root / "eval_rank0.json")))]
    assert not [l for l in eval_out[1].splitlines() if l.startswith("{")]


def _losses(text):
    """(what the line is, its numbers) of each loss and progress line."""
    out = []
    for line in text.splitlines():
        if " loss: " in line:
            head, rest = line.split(" loss: ")
            out.append((head, [float(v) for v in re.findall(r"-?[\d.]+(?:e[-+]?\d+)?|nan|inf", rest)]))
    return out


def test_v2_batch_over_two_ranks_is_one_process(runs):
    from PIL import Image

    root, one, logs = runs
    for run in (1, 2):
        rank0 = logs[0].split(f"=== v2 run {run}")[1].split("=== v2 run")[0]
        rank1 = logs[1].split(f"=== v2 run {run}")[1].split("=== v2 run")[0]
        want, got = _losses(one[run]), _losses(rank0)
        # 4 lines a checkin (at 0, 2, 4; then 4, 6) and one line a window
        assert [w[0] for w in want] == [g[0] for g in got] and len(want) == (14 if run == 1 else 9)
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        assert not _losses(rank1) and "Using seed" not in rank1
        assert ("Resumed state at iteration 4" in rank0) == (run == 2) and "Using seed: 3" in rank0
    pngs = {p.name: p for p in (root / "ranks").glob("*.png")}
    assert sorted(pngs) == sorted(one[2, "pngs"]) == [f"o_{b}.png" for b in range(4)]
    for name, path in pngs.items():
        with Image.open(path) as a, Image.open(root / "one" / name) as b:
            assert a.text == b.text
            assert np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max() <= 1
    with np.load(root / "ranks" / "s.npz") as d:
        got = {k: d[k] for k in d.files}
    want = one[2, "state"]
    assert set(got) == set(want)
    for k in ("iters_done", "n_leaves", "leaf_1", "leaf_4"):
        assert got[k] == want[k] and int(want["leaf_4"]) == 6
    for k in ("leaf_0", "leaf_2", "leaf_3"):
        assert got[k].shape == want[k].shape and got[k].shape[0] == 4
        assert np.abs(got[k] - want[k]).max() <= 1e-5 * np.abs(want[k]).max(), k


if __name__ == "__main__":
    r, ports, root = sys.argv[1:]
    worker(int(r), [int(p) for p in ports.split(",")], root)
