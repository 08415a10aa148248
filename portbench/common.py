"""What every part of the harness shares: the benchmark's file, files
found by name under the harness's folder, seeds mixed from the run's
seed."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent  # portbench/
CHECKOUT = ROOT.parent
SPEC_FILE = CHECKOUT / "BENCHMARK.json"


class Bench:
    """``BENCHMARK.json`` (or another file of its form, for the tests) and
    the data it names: a cell's configuration file (its ``file``), traffic
    mix (``<paths[0]>/traffic/<name>.json``) and limits
    (``<paths[0]>/limits/<cell>.json``), and the table of peaks."""

    def __init__(self, path=None):
        self.path = Path(path) if path else SPEC_FILE
        self.spec = json.loads(self.path.read_text())
        self.base = self.path.parent
        self.dir = self.base / self.spec["paths"][0]

    def _named(self, section: str, name: str) -> dict:
        for entry in self.spec[section]:
            if entry["name"] == name:
                return entry
        raise SystemExit(f"no {section} entry named {name!r} in {self.path.name}")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.base / self._named("configs", name)["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.dir / "limits" / f"{workload}.json").read_text())["limits"]

    def metrics_of(self, section: str, workload: str) -> list:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
        return [m for m in self.spec[section] if workload in m.get("workloads", (workload,))]

    @staticmethod
    def peaks(device_kind: str) -> dict:
        """The card's peaks (``peaks.json``), or {} for a card it lacks."""
        return json.loads((ROOT / "peaks.json").read_text())["devices"].get(device_kind, {})


def system_kind(kind: str):
    """``systems/<kind>.py``: how to build and step a kind of system."""
    return importlib.import_module(f"portbench.systems.{kind}")


def metric_reader(metric: str):
    """``metrics/<name up to its first dot>.py``: ``mfu.train`` and
    ``mfu.dp`` share ``metrics/mfu.py``."""
    return importlib.import_module(f"portbench.metrics.{metric.split('.', 1)[0]}")


def metric_data(base: str) -> dict:
    """A reader's data file, ``metrics/<base>.json``."""
    return json.loads((ROOT / "metrics" / f"{base}.json").read_text())


def mix(*parts: int) -> int:
    """A 63-bit seed from integers of any size (splitmix64's finalizer
    over their sum with odd multipliers), every bit of which depends on
    every part: a CPU ``torch.Generator`` reads only the low 32 bits of
    its seed, and the run's seed is wider than that."""
    mask = (1 << 64) - 1
    x = 0x2545F4914F6CDD1D
    for i, p in enumerate(parts):
        x = (x + (int(p) & mask) * (0x9E3779B97F4A7C15 + 2 * i)) & mask
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
        x ^= x >> 31
    return x & ((1 << 63) - 1)
