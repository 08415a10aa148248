"""Legacy bidirectional-LSTM text encoder — counterpart of
``imagegenerator_tpu/models/text_lstm.py``.

A frozen pretrained embedding (GloVe rows, ``data/legacy.py``) -> a
bidirectional LSTM (batch first) over the full padded length -> the sum
over time steps -> ``Dense(2 * hidden, tem_size)``. The recurrence is
``lax.scan`` in the JAX package, not a Pallas kernel, so the port runs
``nn.LSTM`` (cuDNN's LSTM on the card). Like flax's ``nn.RNN`` without
sequence lengths it runs over every position, padding included, and the
backward direction's outputs stay in input order.

Names: ``Embed_0.weight``, ``lstm.weight_ih_l{n}`` / ``weight_hh_l{n}`` /
``bias_ih_l{n}`` / ``bias_hh_l{n}`` (and ``_reverse``) and
``Dense_0.weight`` / ``.bias``; ``convert.text_lstm_from_flax`` maps the
flax cells' gate kernels onto them.
"""

from __future__ import annotations

import torch
from torch import nn

from imagegenerator_tpu_torch.ops.layers import Dense


class TextEmbeddingLSTM(nn.Module):
    """tokens ``(B, T)`` int -> ``(B, tem_size)``. ``freeze_embedding``
    stops the gradient at the embedding's output, as the JAX module's
    ``stop_gradient`` does."""

    def __init__(self, vocab_size, embed_size=300, hidden_size=256, num_layers=1, tem_size=512,
                 freeze_embedding=True, *, device=None, generator=None):
        super().__init__()
        self.freeze_embedding = freeze_embedding
        weight = torch.empty((vocab_size, embed_size), device=device).normal_(generator=generator)
        self.Embed_0 = nn.Embedding(vocab_size, embed_size, _weight=weight, device=device)
        self.lstm = nn.LSTM(embed_size, hidden_size, num_layers, batch_first=True, bidirectional=True,
                            device=device)
        self.Dense_0 = Dense(2 * hidden_size, tem_size, device=device, generator=generator)

    def forward(self, tokens):
        emb = self.Embed_0(tokens)
        if self.freeze_embedding:
            emb = emb.detach()
        x, _ = self.lstm(emb)
        return self.Dense_0(x.sum(dim=1))
