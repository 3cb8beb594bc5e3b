"""What a cell is: its entry in ``BENCHMARK.json``, its configuration
file and its traffic file, and the plug-in modules they name.

Everything that belongs to one configuration, one traffic mix, one op
kind, one key distribution or one metric lives in a file of its own,
found by the name that ``BENCHMARK.json`` or a traffic file gives it:

    kvbench/configs/<config>.json    a deployment of the store
    kvbench/traffic/<traffic>.json   a traffic mix (read by ``streams``)
    kvbench/kinds/<kind>.py          an op kind (get, put)
    kvbench/keys/<dist>.py           a key distribution (zipfian)
    kvbench/metrics/<metric>.py      a metric's reader

So a later change adds a cell, a mix or a metric by adding files and
entries, and edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Cell:
    """One workload of ``BENCHMARK.json`` with its config and mix."""

    def __init__(self, name: str, root: Path | None = None,
                 bench_dir: Path | None = None):
        self.root = Path(root) if root is not None else HERE.parent
        self.dir = Path(bench_dir) if bench_dir is not None else HERE
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                           f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = self._json("configs", self.entry["config"])
        self.traffic = self._json("traffic", self.entry["traffic"])

    def _json(self, folder: str, name: str) -> dict:
        if not NAME.match(name):
            raise ValueError(f"{name!r} is not a name")
        return json.loads((self.dir / folder / f"{name}.json").read_text())

    def metrics(self, trace: bool) -> list:
        """The cell's metric entries: end-to-end ones untraced, per-layer
        ones traced; a metric without ``workloads`` belongs to every
        cell."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]


def plugin(dir_: Path, folder: str, name: str):
    """Import ``<dir_>/<folder>/<name>.py`` as a module of its own."""
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a name")
    path = Path(dir_) / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"kvbench_{folder}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {folder} module {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
