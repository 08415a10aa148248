"""CLIP under tensor parallelism (``CLIP.shard_model``): two gloo ranks on
a (1, 2) grid split every transformer block of the tiny ViT CLIP (both
towers, 2 heads: one a rank) Megatron-style and must give the JAX
package's ``CLIP`` forward on the same weights at rtol = atol = 1e-5, and
each other's bits. The ranks are this file run as a script (``python
tests/test_torch_clip_tp.py RANK PORT INPUTS OUT``), one thread each.

The packed ``in_proj_weight`` (q over k over v, ``(3 * width, width)``)
is the trap: JAX's ``P(None, 'model')`` cuts its packed dimension into
contiguous halves, which GSPMD may do as it keeps the logical program;
an explicit split must take each of q, k and v by head group."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    rng = np.random.default_rng(4)
    images = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((3, 16), np.int32)
    for row, n in enumerate((5, 16, 9)):  # SOT ... EOT, the EOT id the largest
        tokens[row, :n] = [254, *rng.integers(1, 254, n - 2), 255]
    return images, tokens


def worker(rank: int, port: int, inputs: str, out: str) -> None:
    import torch.distributed as dist

    from imagegenerator_tpu_torch.parallel import dp, mesh, tp
    from imagegenerator_tpu_torch.v2 import clip as tclip

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dp.init_from_env("cpu")
    grid = mesh.make_grid(2)
    with np.load(inputs) as f:
        sd = {k[3:]: torch.from_numpy(f[k]) for k in f.files if k.startswith("sd/")}
        images, tokens = torch.from_numpy(f["images"]), torch.from_numpy(f["tokens"])
    model = tclip.CLIP(tclip.CLIPConfig.tiny(), device="cpu")
    model.load_state_dict(sd, strict=True)
    model.eval().shard_model(tp.ModelShard(grid.model_index, grid.model, grid.model_group))
    with torch.no_grad():
        np.savez(os.path.join(out, f"rank{rank}.npz"), image=model.encode_image(images).numpy(),
                 text=model.encode_text(tokens).numpy(),
                 in_proj=model.visual.transformer.resblocks[0].attn.in_proj_weight.numpy())
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def clip_pair():
    import jax
    import jax.numpy as jnp

    from imagegenerator_tpu.v2 import clip as jclip
    from imagegenerator_tpu_torch import convert
    from imagegenerator_tpu_torch.v2 import clip as tclip

    cfg = jclip.CLIPConfig.tiny()
    params = jax.tree.map(np.asarray, jclip.CLIP(cfg).init(
        jax.random.key(1), jnp.zeros((1, cfg.image_resolution, cfg.image_resolution, 3)),
        jnp.zeros((1, cfg.context_length), jnp.int32))["params"])
    return cfg, params, convert.v2_clip_from_flax(params, tclip.CLIPConfig.tiny())


@pytest.fixture(scope="module")
def ranks(clip_pair, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clip_tp")
    images, tokens = _inputs()
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, images=images, tokens=tokens, **{f"sd/{k}": v for k, v in clip_pair[2].items()})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, paths = [], [tmp / f"rank{r}.log" for r in range(2)]
    try:
        for r, path in enumerate(paths):
            with open(path, "w") as log:
                procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                                               inputs, str(tmp)], stdout=log, stderr=subprocess.STDOUT,
                                              cwd=ROOT, env=env))
        for p in procs:
            p.wait(timeout=180)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{paths[r].read_text()[-4000:]}"
    out = []
    for r in range(2):
        with np.load(tmp / f"rank{r}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


def test_two_model_ranks_match_the_jax_clip(clip_pair, ranks):
    import jax.numpy as jnp

    from imagegenerator_tpu.v2 import clip as jclip

    cfg, params, _ = clip_pair
    images, tokens = _inputs()
    jmodel = jclip.CLIP(cfg)
    want = {"image": jmodel.apply({"params": params}, jnp.asarray(images), method=jclip.CLIP.encode_image),
            "text": jmodel.apply({"params": params}, jnp.asarray(tokens), method=jclip.CLIP.encode_text)}
    for name, w in want.items():
        np.testing.assert_allclose(ranks[0][name], np.asarray(w), err_msg=name, **TOL)
        assert np.array_equal(ranks[0][name], ranks[1][name]), name


def test_each_rank_holds_its_head_group_of_q_k_and_v(clip_pair, ranks):
    """Rank r's packed rows are rows [r C/2, (r+1) C/2) of q, of k and of
    v; a contiguous half of the packed matrix would be something else."""
    from imagegenerator_tpu_torch.parallel import tp
    from imagegenerator_tpu_torch.v2.clip import shard_in_proj

    whole = clip_pair[2]["visual.transformer.resblocks.0.attn.in_proj_weight"]
    C = whole.shape[1]
    for r in range(2):
        want = np.concatenate([whole[i * C + r * C // 2: i * C + (r + 1) * C // 2] for i in range(3)])
        np.testing.assert_array_equal(ranks[r]["in_proj"], want)
        np.testing.assert_array_equal(shard_in_proj(torch.from_numpy(whole), tp.ModelShard(r, 2)).numpy(), want)
        assert not np.array_equal(want, whole[r * 3 * C // 2:(r + 1) * 3 * C // 2])


if __name__ == "__main__":
    r, port, inp, out_dir = sys.argv[1:]
    worker(int(r), int(port), inp, out_dir)
