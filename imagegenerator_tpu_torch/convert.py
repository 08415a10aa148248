"""Carry weights and state between the JAX package and the port.

Both sides meet in a flat dict of numpy arrays keyed
``<field>/<flax path>``, where the field is one of ``Stage2State``'s
(``frozen_params``, ``frozen_gen_stats``, ``params``, ``batch_stats``)
or ``Stage1State``'s (``params``, ``batch_stats``) and the path is
flax's, e.g. ``frozen_params/gen_1/UpBlock_0/ConvTranspose2d_0/kernel``
or ``batch_stats/critic/down_blocks_0/BatchNorm_0/bn/var``. The JAX
side writes it with ``flax.traverse_util.flatten_dict(..., sep="/")``;
``params.npz`` is this dict saved with ``np.savez``. Entries the port has
no module for (the Stage-II critic, its optimizer state) are ignored.

``Stage1State``'s optimizer state and step count ride in the same dict:
``step``, and per module m (``encoder`` ... ``critic``) the
``ScaleByAdamState`` of its optax chain, ``opt_state/<m>/count`` and
``opt_state/<m>/mu/<path>``, ``opt_state/<m>/nu/<path>``, where
``<path>`` is the parameter's flax path under ``params/<m>/``. On the
torch side they are each optimizer's ``step``, ``exp_avg`` and
``exp_avg_sq`` (the moments in the parameter's torch layout).

The v2 models cross differently: their ``state_dict``s carry taming's
(VQGAN) and OpenAI's (CLIP) parameter names, and the JAX package holds
them as nested flax parameter dicts. ``v2_vqgan_from_flax`` /
``v2_vqgan_to_flax`` and ``v2_clip_from_flax`` / ``v2_clip_to_flax`` map
one to the other (numpy arrays both sides; the inverse of the JAX
package's ``v2/convert.py``), and ``v2_state_to_leaves`` /
``v2_state_from_leaves`` the latent-optimization state.

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
from imagegenerator_tpu_torch.train import schedules
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


def _to_torch(arr, layout, device):
    return torch.from_numpy(np.array(_LAYOUTS[layout][0](np.asarray(arr)), np.float32)).to(device)


def _to_flax(t, layout):
    # a copy: for an f32 CPU tensor .numpy() shares the tensor's memory,
    # which the optimizers update in place
    return np.array(_LAYOUTS[layout][1](t.detach().float().cpu().numpy()), order="C", copy=True)


def load_numpy(system, flat: dict, device=None) -> None:
    """Load a flat dict into ``system`` (a system or any module that
    ``entries`` takes, built on any device, ``meta`` included): its
    tensors are replaced by ones on ``device``. A ``Stage1System`` also
    takes the step count and optimizer state where the dict has them."""
    sd = {}
    for key, flat_key, layout in entries(system):
        if flat_key not in flat:
            raise KeyError(f"{flat_key} (for {key}) is missing")
        sd[key] = _to_torch(flat[flat_key], layout, device)
    system.load_state_dict(sd, strict=True, assign=True)
    if isinstance(system, Stage1System) and "step" in flat:
        system.step = int(flat["step"])
        _load_optimizers(system, flat, device)


def to_numpy(system) -> dict:
    """The flat dict of ``system``'s tensors (inverse of ``load_numpy``),
    with a ``Stage1System``'s step count and optimizer state."""
    sd = system.state_dict()
    flat = {
        flat_key: _to_flax(sd[key], layout)
        for key, flat_key, layout in entries(system)
    }
    if isinstance(system, Stage1System):
        flat["step"] = np.asarray(system.step, np.int32)
        flat.update(_optimizers_to_numpy(system))
    return flat


def _param_entries(system):
    """(module, parameter, path under ``params/<module>/``, layout) of
    every parameter of a system."""
    params = dict(system.named_parameters())
    out = []
    for key, flat_key, layout in entries(system):
        if key in params:
            _, module, path = flat_key.split("/", 2)
            out.append((module, params[key], path, layout))
    return out


def _load_optimizers(system, flat, device):
    """optax ``ScaleByAdamState`` (count, mu, nu) -> each optimizer's
    per-parameter ``step``, ``exp_avg``, ``exp_avg_sq``."""
    opts = system.optimizers
    for opt in opts.values():
        opt.state.clear()
    for module, p, path, layout in _param_entries(system):
        count = int(flat[f"opt_state/{module}/count"])
        if count == 0:
            continue
        opts[module].state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": _to_torch(flat[f"opt_state/{module}/mu/{path}"], layout, device),
            "exp_avg_sq": _to_torch(flat[f"opt_state/{module}/nu/{path}"], layout, device),
        }


def _optimizers_to_numpy(system) -> dict:
    opts = system.optimizers
    flat = {
        f"opt_state/{m}/count": np.asarray(schedules.update_count(opt), np.int32)
        for m, opt in opts.items()
    }
    for module, p, path, layout in _param_entries(system):
        state = opts[module].state.get(p) or {}
        for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            t = state.get(key)
            flat[f"opt_state/{module}/{name}/{path}"] = (
                _to_flax(t, layout) if t is not None else _to_flax(torch.zeros_like(p), layout)
            )
    return flat


def stage1_from_numpy(flat: dict, cfg, device=None) -> Stage1System:
    system = Stage1System(cfg, device="meta")
    load_numpy(system, flat, device)
    return system


def stage2_from_numpy(flat: dict, cfg, device=None) -> Stage2System:
    system = Stage2System(cfg, device="meta")
    load_numpy(system, flat, device)
    return system


stage2_to_numpy = to_numpy


# ------------------------------------------------------------------- v2


def _vqgan_entries(c):
    """(taming name, flax path, layout) of every VQGAN tensor."""
    out = []

    def conv(t, f):
        out.extend([(f"{t}.weight", f + ("kernel",), "conv"), (f"{t}.bias", f + ("bias",), None)])

    def norm(t, f):
        out.extend([(f"{t}.weight", f + ("scale",), None), (f"{t}.bias", f + ("bias",), None)])

    def resnet(t, f, in_ch, out_ch):
        norm(f"{t}.norm1", f + ("norm1",))
        conv(f"{t}.conv1", f + ("conv1",))
        norm(f"{t}.norm2", f + ("norm2",))
        conv(f"{t}.conv2", f + ("conv2",))
        if in_ch != out_ch:
            conv(f"{t}.nin_shortcut", f + ("nin_shortcut",))

    def attn(t, f):
        norm(f"{t}.norm", f + ("norm",))
        for name in ("q", "k", "v", "proj_out"):
            conv(f"{t}.{name}", f + (name,))

    def mid(side, ch):
        resnet(f"{side}.mid.block_1", (side, "mid_block_1"), ch, ch)
        attn(f"{side}.mid.attn_1", (side, "mid_attn_1"))
        resnet(f"{side}.mid.block_2", (side, "mid_block_2"), ch, ch)

    conv("encoder.conv_in", ("encoder", "conv_in"))
    cur_res, block_in = c.resolution, c.ch
    for level, mult in enumerate(c.ch_mult):
        for blk in range(c.num_res_blocks):
            resnet(f"encoder.down.{level}.block.{blk}", ("encoder", f"down_{level}_block_{blk}"),
                   block_in, c.ch * mult)
            block_in = c.ch * mult
            if cur_res in c.attn_resolutions:
                attn(f"encoder.down.{level}.attn.{blk}", ("encoder", f"down_{level}_attn_{blk}"))
        if level != c.num_resolutions - 1:
            conv(f"encoder.down.{level}.downsample.conv",
                 ("encoder", f"down_{level}_downsample", "conv"))
            cur_res //= 2
    mid("encoder", block_in)
    norm("encoder.norm_out", ("encoder", "norm_out"))
    conv("encoder.conv_out", ("encoder", "conv_out"))

    block_in = c.ch * c.ch_mult[-1]
    conv("decoder.conv_in", ("decoder", "conv_in"))
    mid("decoder", block_in)
    cur_res = c.resolution // c.f
    for level in reversed(range(c.num_resolutions)):
        for blk in range(c.num_res_blocks + 1):
            resnet(f"decoder.up.{level}.block.{blk}", ("decoder", f"up_{level}_block_{blk}"),
                   block_in, c.ch * c.ch_mult[level])
            block_in = c.ch * c.ch_mult[level]
            if cur_res in c.attn_resolutions:
                attn(f"decoder.up.{level}.attn.{blk}", ("decoder", f"up_{level}_attn_{blk}"))
        if level != 0:
            conv(f"decoder.up.{level}.upsample.conv", ("decoder", f"up_{level}_upsample", "conv"))
            cur_res *= 2
    norm("decoder.norm_out", ("decoder", "norm_out"))
    conv("decoder.conv_out", ("decoder", "conv_out"))
    conv("quant_conv", ("quant_conv",))
    conv("post_quant_conv", ("post_quant_conv",))
    out.append(("quantize.embedding.weight", ("codebook",), None))
    return out


def _clip_entries(c):
    """(OpenAI name, flax path, layout) of every CLIP (ViT) tensor."""
    if c.is_resnet:
        raise NotImplementedError("the ModifiedResNet CLIP towers are not ported")
    out = []

    def dense(t, f):
        out.extend([(f"{t}.weight", f + ("kernel",), "dense"), (f"{t}.bias", f + ("bias",), None)])

    def norm(t, f):
        out.extend([(f"{t}.weight", f + ("scale",), None), (f"{t}.bias", f + ("bias",), None)])

    def block(t, f):
        norm(f"{t}.ln_1", f + ("ln_1",))
        out.append((f"{t}.attn.in_proj_weight", f + ("in_proj", "kernel"), "dense"))
        out.append((f"{t}.attn.in_proj_bias", f + ("in_proj", "bias"), None))
        dense(f"{t}.attn.out_proj", f + ("out_proj",))
        norm(f"{t}.ln_2", f + ("ln_2",))
        dense(f"{t}.mlp.c_fc", f + ("mlp_fc",))
        dense(f"{t}.mlp.c_proj", f + ("mlp_proj",))

    out.append(("visual.conv1.weight", ("visual", "conv1", "kernel"), "conv"))
    for name in ("class_embedding", "positional_embedding", "proj"):
        out.append((f"visual.{name}", ("visual", name), None))
    norm("visual.ln_pre", ("visual", "ln_pre"))
    norm("visual.ln_post", ("visual", "ln_post"))
    for i in range(c.vision_layers):
        block(f"visual.transformer.resblocks.{i}", ("visual", f"block_{i}"))
    out.append(("token_embedding.weight", ("text", "token_embedding", "embedding"), None))
    out.append(("positional_embedding", ("text", "positional_embedding"), None))
    norm("ln_final", ("text", "ln_final"))
    out.append(("text_projection", ("text", "text_projection"), None))
    for i in range(c.text_layers):
        block(f"transformer.resblocks.{i}", ("text", f"block_{i}"))
    return out


def _from_flax(entries_, params) -> dict:
    sd = {}
    for key, path, layout in entries_:
        leaf = params
        for part in path:
            leaf = leaf[part]
        sd[key] = np.array(_LAYOUTS[layout][0](np.asarray(leaf)), np.float32)
    return sd


def _to_flax_tree(entries_, sd) -> dict:
    tree = {}
    for key, path, layout in entries_:
        t = sd[key]
        arr = t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.array(_LAYOUTS[layout][1](arr), order="C", copy=True)
    return tree


def v2_vqgan_from_flax(params: dict, config) -> dict:
    """The JAX ``VQModel``'s parameter dict -> a ``state_dict`` (numpy)
    under taming's names, which the port's ``VQModel`` loads."""
    return _from_flax(_vqgan_entries(config), params)


def v2_vqgan_to_flax(sd: dict, config) -> dict:
    return _to_flax_tree(_vqgan_entries(config), sd)


def v2_clip_from_flax(params: dict, config) -> dict:
    """The JAX ``CLIP``'s parameter dict -> a ``state_dict`` (numpy)
    under OpenAI's names, which the port's ``CLIP`` loads."""
    return _from_flax(_clip_entries(config), params)


def v2_clip_to_flax(sd: dict, config) -> dict:
    return _to_flax_tree(_clip_entries(config), sd)


def v2_state_to_leaves(state) -> list:
    """A port ``LatentState`` -> the flattened leaves of the JAX
    package's ``LatentState`` (numpy): z, Adam count, mu, nu, step."""
    return state.leaves()


def v2_state_from_leaves(leaves, step_size: float, device=None):
    """The inverse of ``v2_state_to_leaves``."""
    from imagegenerator_tpu_torch.v2.engine import LatentState

    return LatentState.from_leaves(leaves, step_size, device)
