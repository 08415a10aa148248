"""The tiny benchmark that each kind of system's tiny form writes is,
file for file and byte for byte, the one ``tiny.py`` wrote when it held
StackGAN's cuts itself."""

from __future__ import annotations

import json

from portbench.common import ROOT, SPEC_FILE
from portbench.tests import tiny

# tiny.py's StackGAN cuts and its make() as they were, kept whole to hold
# the move to
_TINY_BERT = dict(vocab_size=128, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
                  max_position_embeddings=64)
_TINY = {
    1: dict(tem_size=32, c_dim=16, z_dim=12, nd=16, h_dim=16, seq_len=8,
            gen_channels=[24, 12], disc_channels=[12, 24]),
    2: dict(tem_size=32, c_dim=16, z_dim=12, nd=16, h_dim=16, seq_len=8, num_residual=1,
            gen1_channels=[24, 12], g2_in_channels=8, g2_feat_channels=16, g2_res_channels=8,
            g2_up_channels=[16, 8], d2_channels=[8, 16, 32]),
}
_TINY_LIMITS = {"loss_gap": 0.05, "gen_loss_gap": 0.1, "grad_norm_gap": 0.1, "change_norm_gap": 0.2}


def _tiny_config(conf):
    conf = dict(conf, **_TINY[conf["stage"]])
    conf["bert"] = dict(conf["bert"], **_TINY_BERT)
    return conf


def _tiny_mix(mix):
    mix = dict(mix, batch_per_rank=4, ranks=min(mix["ranks"], 2))
    mix["captions"] = dict(mix["captions"], length_histogram=[[3, 1], [5, 2], [8, 1]], first_word_id=5)
    return mix


def _make_before(tmp):
    spec = json.loads(SPEC_FILE.read_text())
    pb = tmp / spec["paths"][0]
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for c in spec["configs"]:
        conf = json.loads((SPEC_FILE.parent / c["file"]).read_text())
        (tmp / c["file"]).write_text(json.dumps(_tiny_config(conf)))
    for name in {w["traffic"] for w in spec["workloads"]}:
        mix = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(_tiny_mix(mix)))
    for w in spec["workloads"]:
        w["chips"] = min(w["chips"], 2)
        (pb / "limits" / f"{w['name']}.json").write_text(json.dumps({"limits": _TINY_LIMITS}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))


def test_stackgan_tiny_form_as_before(tmp_path):
    old, new = tmp_path / "before", tmp_path / "now"
    _make_before(old)
    tiny.make(new)
    files = lambda root: {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    assert files(new) == files(old)
