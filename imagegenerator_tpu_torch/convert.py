"""Carry weights and state between the JAX package and the port.

Both sides meet in a flat dict of numpy arrays keyed
``<field>/<flax path>``, where the field is one of ``Stage2State``'s
(``frozen_params``, ``frozen_gen_stats``, ``params``, ``batch_stats``)
or ``Stage1State``'s (``params``, ``batch_stats``) and the path is
flax's, e.g. ``frozen_params/gen_1/UpBlock_0/ConvTranspose2d_0/kernel``
or ``batch_stats/generator/ResidualBlock_0/BatchNorm_2/bn/var``. The JAX
side writes it with ``flax.traverse_util.flatten_dict(..., sep="/")``;
``params.npz`` is this dict saved with ``np.savez``. Entries the port has
no module for (the critic, optimizer state) are ignored.

Layouts:
  * conv kernel HWIO -> OIHW, and convT kernel ``(kh, kw, out, in)`` ->
    ``(in, out, kh, kw)``: both ``transpose(3, 2, 0, 1)``;
  * Dense kernel ``(in, out)`` -> weight ``(out, in)``: ``.T``;
  * BatchNorm ``scale/bias/mean/var`` -> ``weight/bias/running_mean/
    running_var``;
  * BERT: flax names -> HuggingFace names (``layer_3/attention/query`` ->
    ``encoder.layer.3.attention.self.query``).
"""

from __future__ import annotations

import numpy as np
import torch

from imagegenerator_tpu_torch.models.bert import BertEncoder
from imagegenerator_tpu_torch.ops.layers import BatchNorm, Conv2d, ConvTranspose2d, Dense
from imagegenerator_tpu_torch.train.stage1 import Stage1System
from imagegenerator_tpu_torch.train.stage2 import Stage2System

# layout -> (flax array -> torch array, torch array -> flax array)
_LAYOUTS = {
    None: (lambda a: a, lambda a: a),
    "conv": (lambda a: a.transpose(3, 2, 0, 1), lambda a: a.transpose(2, 3, 1, 0)),
    "dense": (lambda a: a.T, lambda a: a.T),
}


def _bert_entries(num_layers):
    """(HF name, flax path, layout) of every BERT tensor."""
    emb = [
        (f"embeddings.{n}.weight", f"{n}/embedding", None)
        for n in ("word_embeddings", "position_embeddings", "token_type_embeddings")
    ]
    out = emb + [
        ("embeddings.LayerNorm.weight", "embeddings_ln/scale", None),
        ("embeddings.LayerNorm.bias", "embeddings_ln/bias", None),
    ]
    for i in range(num_layers):
        hf, fx = f"encoder.layer.{i}", f"layer_{i}"
        dense = {
            "attention.self.query": "attention/query",
            "attention.self.key": "attention/key",
            "attention.self.value": "attention/value",
            "attention.output.dense": "attention/out",
            "intermediate.dense": "intermediate",
            "output.dense": "output",
        }
        for h, f in dense.items():
            out.append((f"{hf}.{h}.weight", f"{fx}/{f}/kernel", "dense"))
            out.append((f"{hf}.{h}.bias", f"{fx}/{f}/bias", None))
        for h, f in {"attention.output.LayerNorm": "attention_ln",
                     "output.LayerNorm": "output_ln"}.items():
            out.append((f"{hf}.{h}.weight", f"{fx}/{f}/scale", None))
            out.append((f"{hf}.{h}.bias", f"{fx}/{f}/bias", None))
    return out


def _join(*parts, sep):
    return sep.join(p for p in parts if p)


def entries(module):
    """(state_dict key, flat key, layout) of every tensor of ``module``: a
    system, whose ``FLAX_FIELDS`` place each submodule in the JAX state,
    or any other module, whose flat keys are ``params/...`` and
    ``batch_stats/...`` as in its flax variables."""
    fields = getattr(module, "FLAX_FIELDS", {"": ("params", "batch_stats")})
    out = []
    for attr, (pfield, sfield) in fields.items():
        top = getattr(module, attr) if attr else module
        if isinstance(top, BertEncoder):
            for hf, fx, layout in _bert_entries(top.config.num_layers):
                out.append((_join(attr, hf, sep="."), f"{pfield}/{fx}", layout))
            continue
        for name, sub in top.named_modules():
            key = _join(attr, name, sep=".")
            path = _join(pfield, name.replace(".", "/"), sep="/")
            k = lambda leaf: _join(key, leaf, sep=".")
            if isinstance(sub, (Conv2d, ConvTranspose2d, Dense)):
                layout = "dense" if isinstance(sub, Dense) else "conv"
                out.append((k("weight"), f"{path}/kernel", layout))
                if sub.bias is not None:
                    out.append((k("bias"), f"{path}/bias", None))
            elif isinstance(sub, BatchNorm):
                stats = _join(sfield, name.replace(".", "/"), sep="/")
                out += [
                    (k("weight"), f"{path}/bn/scale", None),
                    (k("bias"), f"{path}/bn/bias", None),
                    (k("running_mean"), f"{stats}/bn/mean", None),
                    (k("running_var"), f"{stats}/bn/var", None),
                ]
    return out


def load_numpy(system, flat: dict, device=None) -> None:
    """Load a flat dict into ``system`` (a system or any module that
    ``entries`` takes, built on any device, ``meta`` included): its
    tensors are replaced by ones on ``device``."""
    sd = {}
    for key, flat_key, layout in entries(system):
        if flat_key not in flat:
            raise KeyError(f"{flat_key} (for {key}) is missing")
        arr = np.array(_LAYOUTS[layout][0](np.asarray(flat[flat_key])), np.float32)
        sd[key] = torch.from_numpy(arr).to(device)
    system.load_state_dict(sd, strict=True, assign=True)


def to_numpy(system) -> dict:
    """The flat dict of ``system``'s tensors (inverse of ``load_numpy``)."""
    sd = system.state_dict()
    return {
        flat_key: np.ascontiguousarray(_LAYOUTS[layout][1](sd[key].detach().float().cpu().numpy()))
        for key, flat_key, layout in entries(system)
    }


def stage1_from_numpy(flat: dict, cfg, device=None) -> Stage1System:
    system = Stage1System(cfg, device="meta")
    load_numpy(system, flat, device)
    return system


def stage2_from_numpy(flat: dict, cfg, device=None) -> Stage2System:
    system = Stage2System(cfg, device="meta")
    load_numpy(system, flat, device)
    return system


stage2_to_numpy = to_numpy
