"""The port's evaluation package against the JAX package's on the CPU.

* ``frechet``: ``FeatureMoments`` and ``frechet_distance`` against the
  JAX module's (equal to 1e-12 relative: the same float64 numpy
  arithmetic) and against ``scipy.linalg.sqrtm`` (1e-8), including the
  eps regularisation of a set smaller than its dimension.
* ``clip_eval``: the resize to the tower's resolution against
  ``jax.image.resize(..., "cubic")`` at 256 -> 224, 64 -> 224 and
  300 x 180 -> 224 (f32, 3e-5 absolute on [0, 1] pixels: the two build
  and normalise the resampling weights in another order; PyTorch's
  default bicubic is 0.1 to 0.3 away, which the check must tell), then
  ``image_embeddings`` at inputs equal to, under and over the resolution
  and not square, ``text_embeddings`` and ``clip_score``, one set of
  weights carried across by ``convert`` (f32, rtol 1e-4 with atol 1e-4
  of the largest embedding).
* ``cli``: the JSON line of the port's CLI against the JAX CLI's on one
  ``.pt`` file (a ResNet and a ViT tower) and the same images, from an
  ``.npz``, a directory of PNGs of mixed sizes and one file, with a
  broadcast caption, ``|`` captions and ``@file`` captions: the counts
  equal, ``clip_score`` within 1e-3 absolute, the Fréchet distance within
  1e-4 relative. A set under 2 images, ``--dp`` without ``torchrun`` and
  a ``--batch`` that does not divide end in a usage error, not a
  traceback; PNGs read without Pillow.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.eval import cli as jcli
from imagegenerator_tpu.eval import clip_eval as jclip_eval
from imagegenerator_tpu.eval import frechet as jfrechet
from imagegenerator_tpu.v2 import clip as jclip
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.data import coco
from imagegenerator_tpu_torch.eval import cli, clip_eval, frechet
from imagegenerator_tpu_torch.utils.png import write_png
from imagegenerator_tpu_torch.v2 import clip as tclip
from tests.test_torch_clip_resnet import CONFIGS, seeded_clip_state

RN = tclip.CLIPConfig(**CONFIGS["1111_64px"])
# a ViT whose heads OpenAI's inference finds (width // 64)
VIT = tclip.CLIPConfig(embed_dim=24, image_resolution=32, vision_width=64, vision_layers=2, vision_heads=1,
                       patch_size=8, vocab_size=256, context_length=16, text_width=64, text_layers=1,
                       text_heads=1)


def _stats(rng, dim, n):
    x = rng.standard_normal((n, dim)) @ (rng.standard_normal((dim, dim)) * 0.4 + np.eye(dim))
    return x + rng.standard_normal(dim)


# ----------------------------------------------------------------- frechet
@pytest.mark.parametrize("dim,n", [(8, 40), (32, 20)], ids=["full_rank", "fewer_samples_than_dim"])
def test_moments_and_distance_match_jax_and_scipy(dim, n):
    rng = np.random.default_rng(dim)
    a, b = _stats(rng, dim, n), _stats(rng, dim, n) * 1.3
    ours, theirs = frechet.FeatureMoments(dim), jfrechet.FeatureMoments(dim)
    for chunk in np.array_split(a, 3):
        ours.update(chunk)
        theirs.update(chunk)
    mu, cov = ours.stats()
    np.testing.assert_allclose(mu, a.mean(axis=0), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cov, np.cov(a, rowvar=False), rtol=1e-10, atol=1e-12)
    for got, want in zip((mu, cov), theirs.stats()):
        np.testing.assert_array_equal(got, want)
    mu2, cov2 = frechet.gaussian_stats(b)
    got = frechet.frechet_distance(mu, cov, mu2, cov2)
    assert got == pytest.approx(jfrechet.frechet_distance(mu, cov, mu2, cov2), rel=1e-12)
    if n > dim:  # sqrtm of the product, without regularisation
        from scipy import linalg

        covmean = linalg.sqrtm(cov @ cov2).real
        want = (mu - mu2) @ (mu - mu2) + np.trace(cov) + np.trace(cov2) - 2.0 * np.trace(covmean)
        assert frechet.frechet_distance(mu, cov, mu2, cov2, eps=0.0) == pytest.approx(want, rel=1e-8)
    else:  # rank deficient: eps on both diagonals
        off = np.eye(dim) * 1e-6
        assert got == pytest.approx(frechet.frechet_distance(mu, cov + off, mu2, cov2 + off, eps=0.0), rel=1e-12)
    assert frechet.frechet_distance(mu, cov, mu, cov) == pytest.approx(0.0, abs=1e-6)
    with pytest.raises(ValueError, match="need >= 2 samples"):
        m = frechet.FeatureMoments(dim)
        m.update(a[:1])
        m.stats()
    with pytest.raises(ValueError, match="expected"):
        frechet.FeatureMoments(dim).update(a[:, :-1])


# --------------------------------------------------------------- clip_eval
@pytest.mark.parametrize("shape", [(256, 256), (64, 64), (300, 180)], ids=["256", "64", "300x180"])
def test_resize_is_jaxs_cubic(shape):
    x = np.random.default_rng(0).random((2, *shape, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 224, 224, 3), "cubic"))
    got = tclip.IMAGE_STD * clip_eval.prepare_images(torch.from_numpy(x), 224).numpy() + tclip.IMAGE_MEAN
    np.testing.assert_allclose(got, np.clip(want, 0.0, 1.0), rtol=0, atol=3e-5)
    plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(224, 224),
                                            mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
    assert np.abs(plain.numpy() - want).max() > 0.05


@pytest.fixture(scope="module")
def rn_pair():
    sd = seeded_clip_state(RN, seed=11)
    model = tclip.CLIP(RN, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.eval().requires_grad_(False), jclip.CLIPConfig(**CONFIGS["1111_64px"]), \
        convert.v2_clip_to_flax(sd, RN)


@pytest.mark.parametrize("size", [(64, 64), (40, 40), (100, 100), (70, 50)],
                         ids=["equal", "under", "over", "not_square"])
def test_image_embeddings_match_jax(rn_pair, size):
    model, jcfg, params = rn_pair
    images = np.random.default_rng(1).random((5, *size, 3)).astype(np.float32) * 1.1 - 0.05
    got = clip_eval.image_embeddings(model, images, batch_size=2)
    want = jclip_eval.image_embeddings(jcfg, params, images, batch_size=2)
    assert got.shape == (5, RN.embed_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_text_embeddings_and_clip_score_match_jax(rn_pair):
    model, jcfg, params = rn_pair
    rng = np.random.default_rng(2)
    tokens = np.zeros((3, 16), np.int32)
    for row, n in enumerate((4, 16, 7)):
        tokens[row, :n] = [254, *rng.integers(1, 254, n - 2), 255]
    got = clip_eval.text_embeddings(model, tokens, batch_size=2)
    want = jclip_eval.text_embeddings(jcfg, params, tokens, batch_size=2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    a, b = rng.normal(size=(6, 8)), rng.normal(size=(6, 8))
    assert clip_eval.clip_score(a, b) == pytest.approx(jclip_eval.clip_score(a, b), rel=1e-12)
    assert clip_eval.clip_score(a, a) == pytest.approx(100.0)
    assert clip_eval.clip_score(a, -a) == 0.0
    with pytest.raises(ValueError, match="shapes differ"):
        clip_eval.clip_score(a, b[:5])


# --------------------------------------------------------------------- cli
@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Both towers' ``.pt`` files and the image sets."""
    root = tmp_path_factory.mktemp("eval")
    for name, cfg in (("rn", RN), ("vit", VIT)):
        torch.save({k: torch.from_numpy(v) for k, v in seeded_clip_state(cfg, seed=5).items()}, root / f"{name}.pt")
    rng = np.random.default_rng(3)
    np.savez(root / "samples.npz", images=rng.integers(0, 256, (7, 40, 48, 3), dtype=np.uint8))
    np.savez(root / "ref.npz", images=rng.random((9, 80, 80, 3)).astype(np.float32))
    (root / "pngs").mkdir()
    for i, size in enumerate([(36, 36)] * 4 + [(50, 30)]):  # the last resized to the first's size
        write_png(str(root / "pngs" / f"{i}.png"), rng.integers(0, 256, (*size[::-1], 3), dtype=np.uint8))
    (root / "caps.txt").write_text("a red bus\n\nsnow\nsnow\na dog\nsnow\n")
    return root


def _both(argv, capsys):
    """The port's JSON line and the JAX CLI's, on the same arguments."""
    got = cli.main([*argv, "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == got
    return got, jcli.main(argv)


CASES = {
    "rn_npz_captions": lambda r: ["--samples", f"{r}/samples.npz", "--ref", f"{r}/ref.npz", "-m", "RN50",
                                  "--captions", "a|b|c|a|b|c|a", "--clip_checkpoint", f"{r}/rn.pt",
                                  "--batch", "4"],
    "vit_pngs_file_captions": lambda r: ["--samples", f"{r}/pngs", "--ref", f"{r}/samples.npz",
                                         "--captions", f"@{r}/caps.txt", "--clip_checkpoint", f"{r}/vit.pt",
                                         "--batch", "2"],
    "rn_one_file_broadcast": lambda r: ["--samples", f"{r}/pngs/4.png", "--captions", "a red bus",
                                        "--clip_checkpoint", f"{r}/rn.pt", "-m", "RN50"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_line_is_the_jax_clis(case, files, capsys):
    got, want = _both(CASES[case](files), capsys)
    assert set(got) == set(want)
    for key in ("n_samples", "n_ref", "clip_model", "real_weights"):
        assert got.get(key) == want.get(key), key
    assert abs(got["clip_score"] - want["clip_score"]) <= 1e-3 and 0.0 <= got["clip_score"] <= 100.0
    if "frechet_clip_distance" in want:
        assert got["frechet_clip_distance"] == pytest.approx(want["frechet_clip_distance"], rel=1e-4)
        assert got["frechet_clip_distance"] > 1e-2  # a distance the rounding to 6 digits cannot hide


def test_cli_bf16_and_out_file(files, capsys, tmp_path):
    out = tmp_path / "r.json"
    got = cli.main(CASES["rn_npz_captions"](files) + ["--dtype", "bf16", "--device", "cpu", "-o", str(out)])
    assert json.loads(out.read_text()) == got
    assert np.isfinite(got["frechet_clip_distance"]) and 0.0 <= got["clip_score"] <= 100.0


def test_tiny_random_fallback_says_so(files, capsys):
    got = cli.main(["--samples", f"{files}/samples.npz", "--captions", "x", "--device", "cpu"])
    assert got["clip_model"] == "tiny-random" and got["real_weights"] is False
    assert "randomly-initialized tiny model" in capsys.readouterr().err


@pytest.mark.parametrize("argv,env,message", [
    (["--ref", "{r}/pngs/0.png"], {}, "needs at least 2 images in each set; --ref"),
    (["--captions", "x", "--dp", "2"], {},
     "torchrun --standalone --nproc_per_node 2 -m imagegenerator_tpu_torch.eval.cli"),
    (["--captions", "x", "--dp", "2"], {"WORLD_SIZE": "4"}, "--dp 2, but torchrun started 4 ranks"),
    (["--captions", "x", "--dp", "2", "--batch", "5"], {"WORLD_SIZE": "2"}, "--batch 5 does not divide over --dp 2"),
    ([], {}, "nothing to compute"),
], ids=["under_2_images", "dp_without_torchrun", "dp_not_world", "batch_not_dividing", "nothing"])
def test_usage_errors_are_one_line(files, argv, env, message, monkeypatch, capsys):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        cli.main(["--samples", f"{files}/pngs", *(a.format(r=files) for a in argv), "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert message in err and "Traceback" not in err and err.splitlines()[-1].startswith("python -m")


def test_the_jax_cli_crashes_on_a_set_under_2_images(files):
    """The fault the port's CLI does not copy: a raw ``ValueError`` from
    ``FeatureMoments.stats``."""
    with pytest.raises(ValueError, match="need >= 2 samples"):
        jcli.main(["--samples", f"{files}/pngs/0.png", "--ref", f"{files}/pngs", "--clip_checkpoint",
                   f"{files}/vit.pt"])


def test_sets_read_without_pillow(files, monkeypatch):
    with_pillow = cli.load_image_set(f"{files}/pngs")
    assert with_pillow.shape == (5, 36, 36, 3)
    np.testing.assert_array_equal(with_pillow, jcli.load_image_set(f"{files}/pngs"))
    monkeypatch.setattr(coco, "_pillow", lambda: None)
    one = cli.load_image_set(f"{files}/pngs/3.png")
    np.testing.assert_array_equal(one, with_pillow[3:4])
    with pytest.raises(ValueError, match="mixed sizes are resized with Pillow"):
        cli.load_image_set(f"{files}/pngs")


def test_a_ranks_share_of_each_batch(files):
    """Rank 1 of 2 gets the second half of each batch, the ragged last
    one too, from every source."""
    for path in (f"{files}/samples.npz", f"{files}/pngs"):
        whole = cli.load_image_set(path)
        got = list(cli.ImageSet(path).batches(4, share=(1, 2)))
        n = len(whole)
        want = [np.array_split(np.arange(s, min(s + 4, n)), 2)[1] for s in range(0, n, 4)]
        assert [list(i) for i, _ in got] == [list(w) for w in want if len(w)]
        for idx, images in got:
            np.testing.assert_array_equal(images, whole[idx])


def test_flags_are_the_jax_clis_and_the_default_is_the_card(files):
    def surface(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type) for a in parser._actions if a.dest != "help"}

    ours, theirs = surface(cli.get_parser()), surface(jcli.get_parser())
    assert set(ours) - set(theirs) == {"device"}
    assert {k: v for k, v in ours.items() if k != "device"} == theirs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--samples", f"{files}/pngs", "--captions", "x"])
