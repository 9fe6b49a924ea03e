"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads``) names a configuration and a traffic mix; the
configuration's file is ``configs/<config>.json`` (its ``family`` names
the window driver, ``families/<family>.py``), the mix's is
``traffic/<traffic>.json``, the limits of the cell's comparison are
``limits/<cell>.json``, and each per-layer metric is read by
``metrics/<metric>.py``. A later change adds a configuration, a mix, a
cell or a metric by adding such files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class ManifestError(RuntimeError):
    pass


class Manifest:
    def __init__(self, data: dict, root: Path):
        self.data = data
        self.root = root
        self.cells = {w["name"]: w for w in data["workloads"]}
        self.configs = {c["name"]: c for c in data["configs"]}

    @classmethod
    def load(cls, root: Path) -> "Manifest":
        path = root / "BENCHMARK.json"
        if not path.exists():
            raise ManifestError(f"no BENCHMARK.json at {root}")
        return cls(json.loads(path.read_text()), root)

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise ManifestError(f"no workload {name!r} in BENCHMARK.json")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        entry = self.configs[cell["config"]]
        return read_json(self.root / entry["file"])

    def traffic(self, cell: dict) -> dict:
        return read_json(HERE / "traffic" / f"{cell['traffic']}.json")

    def metrics(self, cell: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that ``cell``
        reports."""
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]


def read_json(path: Path) -> dict:
    if not path.exists():
        raise ManifestError(f"missing {path}")
    return json.loads(path.read_text())


def family(name: str):
    """The window driver ``families/<name>.py``."""
    return importlib.import_module(f"portbench.families.{name}")


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        raise ManifestError(f"no reader {path} for the metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
