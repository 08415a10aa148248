"""A tiny copy of the benchmark for the CPU tests: the same cells,
metrics and harness, each configuration and mix in the tiny form its
kind of system gives (``tiny_config``, ``tiny_mix`` and ``TINY_LIMITS``
of ``systems/<kind>.py``), and a cell over several cards over
``TINY_RANKS`` processes (gloo on the CPU), written under a directory of
the test's own."""

from __future__ import annotations

import json
from pathlib import Path

from portbench.common import ROOT, SPEC_FILE, system_kind

TINY_RANKS = 2


def make(tmp: Path) -> Path:
    """Write the tiny benchmark under ``tmp``; returns its spec file."""
    tmp = Path(tmp)
    spec = json.loads(SPEC_FILE.read_text())
    pb = tmp / spec["paths"][0]
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    kinds = {}
    for c in spec["configs"]:
        conf = json.loads((SPEC_FILE.parent / c["file"]).read_text())
        kinds[c["name"]] = system_kind(conf["system"])
        (tmp / c["file"]).write_text(json.dumps(kinds[c["name"]].tiny_config(conf)))
    mixes = {}
    for w in spec["workloads"]:
        kind = kinds[w["config"]]
        if mixes.setdefault(w["traffic"], kind) is not kind:
            raise ValueError(f"mix {w['traffic']} serves two kinds of system")
        w["chips"] = min(w["chips"], TINY_RANKS)
        (pb / "limits" / f"{w['name']}.json").write_text(json.dumps({"limits": kind.TINY_LIMITS}))
    for name, kind in mixes.items():
        mix = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
        tiny = dict(kind.tiny_mix(mix), ranks=min(mix["ranks"], TINY_RANKS))
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(tiny))
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path
