"""The port's weights-day playbook
(``imagegenerator_tpu_torch/tools/validate_real_weights.py``) against the
JAX package's (``tools/validate_real_weights.py``) on the synthetic
checkpoints that ``tests/test_weights_day.py`` builds (seeded torch
modules under published names, a BPE merges file), the port on the CPU.

Both write the same golden files; the port's hold to the JAX tool's in
f32: VQGAN indices equal, ``z_q`` and the decoded image to atol 1e-4,
CLIP's text and image embeddings and BERT's CLS to rtol 1e-4. The
decoded images differ by f32 rounding through the VQGAN decoder, and how
much depends on the thread count of the port's CPU GroupNorm statistics
(close to 1e-4 at 1 thread, well inside it at 4): the port runs at a
pinned thread count, and both f32 images are held to a float64
evaluation of the port's decoder on the same weights and latents, at the
same 1e-4. The
generated images are not compared (threefry and torch draws differ);
instead the port's CLIPScore section scores the JAX run's sample, matched
prompt and foil within 1e-3 of the JAX section's scores."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imagegenerator_tpu.eval import clip_eval as jax_clip_eval
from imagegenerator_tpu_torch.tools import validate_real_weights as port_tool
from imagegenerator_tpu_torch.v2 import generate as port_generate
from imagegenerator_tpu_torch.v2 import vqgan as port_vqgan
from imagegenerator_tpu_torch.v2.engine import frozen
from tests.test_weights_day import synthetic_files  # noqa: F401  (the fixture, reused)

torch.set_num_threads(2)
# the port's run, whatever thread count the tests before it left behind
THREADS = 4
GOLDENS = ("vqgan_roundtrip.npz", "clip_embeds.npz", "bert_cls.npz", "weights_day_sample.png", "MANIFEST.json")


def _argv(files, out):
    return ["--vqgan_config", str(files / "vq.yaml"), "--vqgan_checkpoint", str(files / "vq.ckpt"),
            "--clip_checkpoint", str(files / "clip.pt"), "--bert_checkpoint", str(files / "bert.bin"),
            "--bpe_vocab", str(files / "bpe.txt.gz"), "--iterations", "2", "--out", str(out)]


@pytest.fixture(scope="module")
def runs(synthetic_files, tmp_path_factory):  # noqa: F811
    """Both tools over the same files: their output directories, and the
    JAX evaluation section's (matched, foil) CLIPScores, read as it
    computes them."""
    from validate_real_weights import main as jax_main  # tools/, on the path test_weights_day sets

    root = tmp_path_factory.mktemp("weights_day_both")
    scores = []
    with pytest.MonkeyPatch.context() as mp:
        score = jax_clip_eval.clip_score
        mp.setattr(jax_clip_eval, "clip_score", lambda *a: scores.append(score(*a)) or scores[-1])
        jax_main(_argv(synthetic_files, root / "jax"))
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        port_tool.main(_argv(synthetic_files, root / "port") + ["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    return root / "jax", root / "port", scores


def _f64_group_norm(self, x):
    """The port's GroupNorm, in float64 for a float64 input (it takes its
    statistics in f32 otherwise)."""
    return F.group_norm(x, self.groups, self.weight.double(), self.bias.double(), 1e-6)


def _decoded_in_f64(files, z_q):
    """The port's VQGAN decoder in float64 (convolutions, GroupNorm,
    attention) on the checkpoint's weights and the latents ``z_q``."""
    cfg, state = port_generate.load_vqgan(str(files / "vq.yaml"), str(files / "vq.ckpt"))
    model = frozen(port_vqgan.VQModel, cfg, state, torch.float64, device="cpu").double()
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(port_vqgan.GroupNorm, "forward", _f64_group_norm)
        return model.decode(torch.from_numpy(z_q).double()).numpy()


def test_the_same_goldens_and_sections(runs):
    jax_out, port_out, _ = runs
    for name in GOLDENS:
        assert (jax_out / name).exists() and (port_out / name).exists(), name
    for name in GOLDENS[:3]:
        with np.load(jax_out / name) as j, np.load(port_out / name) as p:
            assert sorted(j.files) == sorted(p.files), name
    manifests = [json.loads((out / "MANIFEST.json").read_text()) for out in (jax_out, port_out)]
    assert manifests[0] == manifests[1] == {"validated": ["vqgan", "clip", "bert", "generation", "eval"]}


def test_goldens_match_the_jax_tool(runs):
    jax_out, port_out, _ = runs
    load = lambda out, name: dict(np.load(out / f"{name}.npz"))
    j, p = load(jax_out, "vqgan_roundtrip"), load(port_out, "vqgan_roundtrip")
    np.testing.assert_array_equal(p["indices"], j["indices"])
    for k in ("z_q", "decoded"):
        assert p[k].shape == j[k].shape, k
        np.testing.assert_allclose(p[k], j[k], rtol=0, atol=1e-4, err_msg=k)
    j, p = load(jax_out, "clip_embeds"), load(port_out, "clip_embeds")
    np.testing.assert_array_equal(p["tokens"], j["tokens"])
    for k in ("text_embeds", "image_embeds"):
        np.testing.assert_allclose(p[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    j, p = load(jax_out, "bert_cls"), load(port_out, "bert_cls")
    np.testing.assert_array_equal(p["input_ids"], j["input_ids"])
    np.testing.assert_allclose(p["cls"], j["cls"], rtol=1e-4, atol=1e-6)


def test_decoded_images_lie_near_a_float64_witness(runs, synthetic_files):  # noqa: F811
    jax_out, port_out, _ = runs
    j, p = (dict(np.load(out / "vqgan_roundtrip.npz")) for out in (jax_out, port_out))
    witness = _decoded_in_f64(synthetic_files, j["z_q"])
    assert witness.dtype == np.float64 and witness.shape == p["decoded"].shape
    for name, decoded in (("port", p["decoded"]), ("jax", j["decoded"])):
        assert decoded.dtype == np.float32, name
        np.testing.assert_allclose(decoded, witness, rtol=0, atol=1e-4, err_msg=name)


def test_port_scores_the_jax_sample_as_jax_does(runs, synthetic_files):  # noqa: F811
    jax_out, _, jax_scores = runs
    assert len(jax_scores) == 2
    args = port_tool.get_parser().parse_args(_argv(synthetic_files, jax_out) + ["--device", "cpu"])
    matched, foil = port_tool.validate_eval(args, str(jax_out), torch.device("cpu"))
    np.testing.assert_allclose([matched, foil], jax_scores, rtol=0, atol=1e-3)


def test_no_inputs_is_a_usage_error(tmp_path):
    with pytest.raises(SystemExit):
        port_tool.main(["--out", str(tmp_path), "--device", "cpu"])
    assert not (tmp_path / "MANIFEST.json").exists()


def test_the_default_device_is_the_card(synthetic_files, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_tool.main(["--bert_checkpoint", str(synthetic_files / "bert.bin"), "--out", str(tmp_path)])
    assert not (tmp_path / "bert_cls.npz").exists()


def test_a_missing_file_is_an_error(tmp_path):
    with pytest.raises(FileNotFoundError):
        port_tool.main(["--bert_checkpoint", str(tmp_path / "absent.bin"), "--out", str(tmp_path),
                        "--device", "cpu"])
