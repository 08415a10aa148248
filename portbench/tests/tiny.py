"""A tiny copy of the benchmark for the CPU tests: the same cells,
metrics and harness, each configuration at the port's tiny widths
(``Stage1Config.tiny()``, ``Stage2Config.tiny()``) and each mix at a few
rows of short captions, written under a directory of the test's own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.common import SPEC_FILE, ROOT

TINY_BERT = dict(vocab_size=128, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
                 max_position_embeddings=64)
TINY = {
    1: dict(tem_size=32, c_dim=16, z_dim=12, nd=16, h_dim=16, seq_len=8,
            gen_channels=[24, 12], disc_channels=[12, 24]),
    2: dict(tem_size=32, c_dim=16, z_dim=12, nd=16, h_dim=16, seq_len=8, num_residual=1,
            gen1_channels=[24, 12], g2_in_channels=8, g2_feat_channels=16, g2_res_channels=8,
            g2_up_channels=[16, 8], d2_channels=[8, 16, 32]),
}
# limits of the tiny cells: sound runs in bf16 on the CPU read under a
# tenth of these, every planted fault over them
TINY_LIMITS = {"loss_gap": 0.05, "gen_loss_gap": 0.1, "grad_norm_gap": 0.1, "change_norm_gap": 0.2}


def tiny_config(conf: dict, **overrides) -> dict:
    conf = dict(conf, **TINY[conf["stage"]], **overrides)
    conf["bert"] = dict(conf["bert"], **TINY_BERT)
    return conf


def tiny_mix(mix: dict) -> dict:
    mix = dict(mix, batch_per_rank=4)
    mix["captions"] = dict(mix["captions"], length_histogram=[[3, 1], [5, 2], [8, 1]], first_word_id=5)
    return mix


def make(tmp: Path, limits: dict | None = None, **overrides) -> Path:
    """Write the tiny benchmark under ``tmp``; returns its spec file."""
    tmp = Path(tmp)
    spec = json.loads(SPEC_FILE.read_text())
    pb = tmp / spec["paths"][0]
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for c in spec["configs"]:
        conf = json.loads((SPEC_FILE.parent / c["file"]).read_text())
        (tmp / c["file"]).write_text(json.dumps(tiny_config(conf, **overrides)))
    for name in {w["traffic"] for w in spec["workloads"]}:
        mix = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(tiny_mix(mix)))
    for w in spec["workloads"]:
        (pb / "limits" / f"{w['name']}.json").write_text(json.dumps({"limits": limits or TINY_LIMITS}))
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path
