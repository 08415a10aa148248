"""The legacy GloVe / LSTM text path: ``data/legacy.py`` against the JAX
package's module on the same inputs, and ``models/text_lstm.py``'s
``TextEmbeddingLSTM`` against the flax module on the same weights
(``convert.text_lstm_from_flax``) at rtol = atol = 1e-5, f32 on the CPU,
one and two layers, over padded batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.data import legacy as jlegacy
from imagegenerator_tpu.models import TextEmbeddingLSTM as JLSTM
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.data import legacy
from imagegenerator_tpu_torch.models.text_lstm import TextEmbeddingLSTM

WORDS = ["a", "red", "square", "dog", "on", "the", "grass", ","]
CAPTIONS = ["A red square, on the grass!", "a dog", "the dog on a red, red square (unknown)", ""]
TOL = dict(rtol=1e-5, atol=1e-5)


def test_tokenize_and_numericalize_match_jax():
    for text in CAPTIONS + ["Hello, WORLD... 42 cats & 7 dogs", "tab\tand\nnewline"]:
        assert legacy.tokenize(text) == jlegacy.tokenize(text)
    vocab, jvocab = legacy.Vocabulary.synthetic(WORDS, dim=6), jlegacy.Vocabulary.synthetic(WORDS, dim=6)
    np.testing.assert_array_equal(vocab.vectors, jvocab.vectors)
    assert vocab.stoi == jvocab.stoi
    for text in CAPTIONS:
        assert vocab.numericalize(text) == jvocab.numericalize(text)


def test_vocabulary_unk_and_pad():
    vocab = legacy.Vocabulary.synthetic(["a", "red", "square"], dim=8)
    assert len(vocab) == 5 and vocab.dim == 8
    np.testing.assert_allclose(vocab.vectors[vocab.unk_index], vocab.vectors[:3].mean(axis=0), atol=1e-6)
    np.testing.assert_array_equal(vocab.vectors[vocab.pad_index], 0.0)
    assert vocab.numericalize("a RED unknownword") == [vocab.stoi["a"], vocab.stoi["red"], vocab.unk_index]


def test_glove_file_parsing_matches_jax(tmp_path):
    path = tmp_path / "glove.txt"
    path.write_text("hello 1.0 2.0 3.0\nworld 4.0 5.0 6.5\n\nbad\n, -1 0 1e-3\nextra 7 8 9\n")
    for max_words in (None, 2):
        got = legacy.Vocabulary.from_glove_file(str(path), max_words)
        want = jlegacy.Vocabulary.from_glove_file(str(path), max_words)
        assert got.stoi == want.stoi and got.dim == 3
        np.testing.assert_array_equal(got.vectors, want.vectors)
    np.testing.assert_array_equal(got.vectors[got.stoi["world"]], [4.0, 5.0, 6.5])


def test_collate_matches_jax():
    vocab = legacy.Vocabulary.synthetic(WORDS, dim=4)
    jvocab = jlegacy.Vocabulary.synthetic(WORDS, dim=4)
    got = legacy.LegacyCollate(vocab, max_length=6)(CAPTIONS)
    want = jlegacy.LegacyCollate(jvocab, max_length=6)(CAPTIONS)
    assert got["input_ids"].shape == (4, 6) and got["input_ids"].dtype == np.int32
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    assert (got["input_ids"][3] == vocab.pad_index).all()


@pytest.mark.parametrize("num_layers", [1, 2])
def test_lstm_matches_flax(num_layers):
    """vocab -> collate -> the encoder: the same tem as the flax module on
    the GloVe rows and the flax init, its weights through the converter;
    both converters invert each other; the embedding takes no gradient."""
    vocab = legacy.Vocabulary.synthetic(WORDS, dim=8, seed=3)
    tokens = legacy.LegacyCollate(vocab, max_length=7)(CAPTIONS)["input_ids"]
    kw = dict(vocab_size=len(vocab), embed_size=8, hidden_size=5, num_layers=num_layers, tem_size=16)
    jmodel = JLSTM(**kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(num_layers), tokens)["params"])
    params["Embed_0"]["embedding"] = vocab.vectors
    # the LSTM's biases are zero at init; give them values so the mapping shows
    rng = np.random.default_rng(num_layers)
    for name, cell in params.items():
        for gate in cell:
            if "bias" in cell[gate] and name.startswith("LSTMCell_"):
                cell[gate]["bias"] = rng.normal(size=cell[gate]["bias"].shape).astype(np.float32) * 0.3
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens)))

    sd = convert.text_lstm_from_flax(params, num_layers)
    port = TextEmbeddingLSTM(**kw, device="cpu")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    got = port(torch.from_numpy(tokens))
    assert got.shape == (4, 16)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)

    back = convert.text_lstm_to_flax(port.state_dict(), num_layers)
    flat = lambda tree: {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
                         for path, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert flat(back).keys() == flat(params).keys()
    for k, v in flat(params).items():
        np.testing.assert_allclose(flat(back)[k], v, rtol=0, atol=1e-7, err_msg=k)

    got.sum().backward()
    assert port.Embed_0.weight.grad is None
    assert port.lstm.weight_ih_l0.grad is not None and port.Dense_0.weight.grad is not None
