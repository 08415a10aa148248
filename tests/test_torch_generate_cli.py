"""The port's v2 generation CLI on ``--cuda_device cpu`` with the tiny
fallback models (no checkpoint files): the PNG and its ``comment`` chunk
as Pillow reads it, ``--prompts_file`` batches, ``--state`` resume, a
checkpoint under taming's and OpenAI's names loaded from disk, the
default device, and what is not ported (``NotImplementedError``)."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from imagegenerator_tpu.v2 import arg_parser as jarg_parser
from imagegenerator_tpu.v2 import init_image as jinit_image
from imagegenerator_tpu.v2 import prompts as jprompts
from imagegenerator_tpu.v2 import tokenizer as jtokenizer
from imagegenerator_tpu_torch.v2 import arg_parser, generate, init_image, prompts, tokenizer
from imagegenerator_tpu_torch.v2.clip import CLIP, CLIPConfig
from imagegenerator_tpu_torch.v2.vqgan import VQGANConfig, VQModel

TINY = ["-cd", "cpu", "-s", "32", "32", "-sd", "0"]


def _run(capsys, *args):
    generate.main([*TINY, *args])
    return capsys.readouterr()


def test_cli_writes_a_png_with_the_prompt_in_its_comment(tmp_path, capsys):
    out = tmp_path / "o.png"
    io = _run(capsys, "-p", "a fox|sea:0.5", "-i", "3", "-se", "2", "-o", str(out))
    assert "randomly-initialized tiny model" in io.err
    lines = io.out.splitlines()
    assert lines[0] == "Using seed: 0"
    # as in the JAX package, a checkin falls on multiples of --save_every only
    assert [l.split(",")[0] for l in lines if l.startswith("i: ")] == ["i: 0", "i: 2"]
    assert [l.split(" ")[1] for l in lines if l.startswith("progress")] == ["2/3", "3/3"]
    assert all(np.isfinite(float(l.split("loss: ")[1].split(",")[0])) for l in lines if "loss: " in l)
    with Image.open(out) as im:
        assert im.size == (32, 32) and im.mode == "RGB"
        assert im.text == {"comment": "['a fox', 'sea:0.5']"}
    # the same seed gives the same image; another seed another
    again = tmp_path / "again.png"
    _run(capsys, "-p", "a fox|sea:0.5", "-i", "3", "-se", "2", "-o", str(again))
    assert again.read_bytes() == out.read_bytes()
    generate.main(["-cd", "cpu", "-s", "32", "32", "-sd", "1", "-p", "a fox|sea:0.5", "-i", "3", "-se", "2",
                   "-o", str(again)])
    assert again.read_bytes() != out.read_bytes()


def test_a_comment_outside_latin1_reaches_pillow(tmp_path, capsys):
    out = tmp_path / "o.png"
    _run(capsys, "-p", "一只狐狸", "-i", "1", "-o", str(out))
    with Image.open(out) as im:
        assert im.text == {"comment": "['一只狐狸']"}


def test_prompts_file_runs_one_batch_and_writes_one_png_per_line(tmp_path, capsys):
    listing = tmp_path / "p.txt"
    listing.write_text("a fox|sea:0.5\n\nred bus\n")
    io = _run(capsys, "--prompts_file", str(listing), "-i", "2", "-se", "2", "-o", str(tmp_path / "o.png"))
    assert sum(l.startswith("[0] i: ") for l in io.out.splitlines()) == 2
    assert sum(l.startswith("[1] i: ") for l in io.out.splitlines()) == 2
    with Image.open(tmp_path / "o_0.png") as a, Image.open(tmp_path / "o_1.png") as b:
        assert a.text["comment"] == "['a fox', 'sea:0.5']" and b.text["comment"] == "['red bus']"
    assert not (tmp_path / "o.png").exists()


@pytest.mark.parametrize("init", ["random", "gradient"])
def test_init_images_are_encoded(init, tmp_path, capsys):
    io = _run(capsys, "-p", "a fox", "-i", "1", "-se", "1", "-in", init, "-o", str(tmp_path / "o.png"))
    assert "i: 1, loss: " in io.out


def test_state_resume_continues_where_the_run_stopped(tmp_path, capsys):
    state, out = tmp_path / "s.npz", tmp_path / "o.png"
    common = ["-p", "a fox", "-se", "2", "--state", str(state)]
    _run(capsys, *common, "-i", "4", "-o", str(out))
    with np.load(state) as d:
        assert int(d["iters_done"]) == 4 and int(d["leaf_4"]) == 4 and int(d["leaf_1"]) == 4
    io = _run(capsys, *common, "-i", "6", "-o", str(out))
    assert f"Resumed state at iteration 4 from {state}" in io.out
    assert [l.split(",")[0] for l in io.out.splitlines() if l.startswith("i: ")] == ["i: 4", "i: 6"]
    with np.load(state) as d:
        resumed = {k: d[k] for k in d.files}
    # an uninterrupted run of 6 ends in the same state
    other = tmp_path / "t.npz"
    _run(capsys, "-p", "a fox", "-se", "2", "--state", str(other), "-i", "6", "-o", str(out))
    with np.load(other) as d:
        assert int(d["iters_done"]) == 6
        for k in d.files:
            np.testing.assert_array_equal(d[k], resumed[k], err_msg=k)
    # nothing left to do: no step, the state stays
    io = _run(capsys, *common, "-i", "6", "-o", str(out))
    assert "progress" not in io.out
    # another image size does not resume from it
    with pytest.raises(ValueError, match="leaf 0"):
        generate.main(["-cd", "cpu", "-s", "16", "16", "-sd", "0", *common, "-i", "8", "-o", str(out)])


def test_checkpoints_under_published_names_load_from_disk(tmp_path, capsys):
    """A taming ``.ckpt`` (Lightning layout, with loss entries) and its
    yaml, and an OpenAI CLIP ``state_dict`` (with its non-parameter
    entries), written from seeded tiny models."""
    gen = torch.Generator().manual_seed(0)
    vq_cfg = VQGANConfig.tiny()
    # heads are inferred as width // 64, as OpenAI's build_model does
    clip_cfg = CLIPConfig(**{**CLIPConfig.tiny().__dict__, "vocab_size": 300, "vision_width": 64,
                             "text_width": 128, "vision_heads": 1, "text_heads": 2})
    vq_sd = VQModel(vq_cfg, device="cpu", generator=gen).state_dict()
    vq_sd["loss.discriminator.main.0.weight"] = torch.zeros(3)
    clip_sd = CLIP(clip_cfg, device="cpu", generator=gen).state_dict()
    clip_sd.update(logit_scale=torch.tensor(4.6), input_resolution=torch.tensor(32),
                   context_length=torch.tensor(16), vocab_size=torch.tensor(300))
    torch.save({"state_dict": vq_sd, "global_step": 7}, tmp_path / "vq.ckpt")
    torch.save(clip_sd, tmp_path / "clip.pt")
    (tmp_path / "vq.yaml").write_text(json.dumps({"model": {
        "target": "taming.models.vqgan.VQModel",
        "params": {"embed_dim": 8, "n_embed": 32, "ddconfig": {
            "z_channels": 8, "resolution": 32, "ch": 8, "ch_mult": [1, 2], "num_res_blocks": 1,
            "attn_resolutions": [16]}}}}))
    got_cfg, got_sd = generate.load_vqgan(str(tmp_path / "vq.yaml"), str(tmp_path / "vq.ckpt"))
    assert got_cfg == vq_cfg and not any(k.startswith("loss.") for k in got_sd)
    got_clip, got_clip_sd = generate.load_clip("ViT-B/32", str(tmp_path / "clip.pt"))
    assert got_clip == clip_cfg and "logit_scale" not in got_clip_sd
    io = _run(capsys, "-p", "a fox", "-i", "1", "-se", "1", "-conf", str(tmp_path / "vq.yaml"),
              "-ckpt", str(tmp_path / "vq.ckpt"), "--clip_checkpoint", str(tmp_path / "clip.pt"),
              "-o", str(tmp_path / "o.png"))
    assert "warn" not in io.err and "i: 1, loss: " in io.out
    (tmp_path / "bad.yaml").write_text(json.dumps({"model": {"target": "taming.models.cond_transformer.Net2NetTransformer", "params": {}}}))
    with pytest.raises(ValueError, match="unknown model type"):
        generate.load_vqgan(str(tmp_path / "bad.yaml"), str(tmp_path / "vq.ckpt"))


@pytest.mark.parametrize("args,match", [
    (["-p", "a fox", "-m", "RN50"], "ModifiedResNet"),
    (["-p", "a fox", "--profile_dir", "prof"], "profile_dir"),
    (["-p", "a fox", "-s", "64", "64"], "lanczos"),
])
def test_what_is_not_ported_raises(args, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        generate.main(["-cd", "cpu", "-sd", "0", "-i", "1", "-o", str(tmp_path / "o.png"), *args])


def test_cli_defaults_to_the_card_and_refuses_unknown_models(tmp_path):
    assert arg_parser.get_parser().parse_args([]).cuda_device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            generate.main(["-p", "a fox", "-i", "1", "-o", str(tmp_path / "o.png")])
    with pytest.raises(ValueError, match="unsupported CLIP model"):
        generate.main(["-cd", "cpu", "-p", "a fox", "-m", "ViT-H/14"])


def test_flags_are_the_jax_packages_but_for_device_and_rng():
    def surface(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs)
                for a in parser._actions if a.dest != "help"}

    ours, theirs = surface(arg_parser.get_parser(128)), surface(jarg_parser.get_parser(128))
    assert set(theirs) - set(ours) == {"rng_impl"} and set(ours) <= set(theirs)
    for dest, spec in ours.items():
        if dest == "cuda_device":
            assert spec[0] == theirs[dest][0] and spec[1] == "cuda"
        else:
            assert spec == theirs[dest], dest


def test_the_ports_own_copies_agree_with_the_jax_packages():
    texts = ["a watercolor fox", "It's 3 o'clock — café!", "一只狐狸 <|endoftext|>", ""]
    for args in ((16, 256), (77, 49408)):
        np.testing.assert_array_equal(tokenizer.open_tokenizer(None, *args)(texts),
                                      jtokenizer.open_tokenizer(None, *args)(texts))
    assert tokenizer.split_words(texts[1]) == jtokenizer.split_words(texts[1])
    for fn in ("random_noise_image", "random_gradient_image"):
        got = getattr(init_image, fn)(24, 16, np.random.default_rng(3))
        want = getattr(jinit_image, fn)(24, 16, np.random.default_rng(3))
        np.testing.assert_array_equal(got, want)
    for text in ("a fox", "a fox:2", "a fox:-0.5:0.3", "a: b::0.1", "x::"):
        assert prompts.split_prompt(text) == jprompts.split_prompt(text)


def test_spherical_dist_and_prompt_loss_match_jax():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    u = rng.normal(size=(6, 16)).astype(np.float32)
    v = rng.normal(size=(3, 16)).astype(np.float32)
    v[1] = u[2]  # zero distance: the guarded sqrt
    v[2] = -u[3]  # antipodal: the clamped arcsin
    got = prompts.spherical_dist(torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(jprompts.spherical_dist(jnp.asarray(u), jnp.asarray(v))),
                               rtol=1e-5, atol=1e-6)
    for weight, stop in ((1.0, -np.inf), (-0.5, -0.4), (2.0, 3.0)):
        leaf = torch.from_numpy(u).requires_grad_(True)
        spec = prompts.PromptSpec(torch.from_numpy(v[:1]), torch.tensor(weight), torch.tensor(stop))
        loss = prompts.prompt_loss(leaf, spec)
        loss.backward()
        jspec = jprompts.PromptSpec(jnp.asarray(v[:1]), jnp.asarray(weight), jnp.asarray(stop))
        want, grad = jax.value_and_grad(lambda a: jprompts.prompt_loss(a, jspec))(jnp.asarray(u))
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(grad), rtol=1e-4, atol=1e-6)
