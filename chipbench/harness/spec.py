"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own under the benchmark's folder:

* a configuration: the JSON file its entry names (``file``), and the plain
  reference module that file names (``reference/<name>.py``);
* a traffic mix: ``traffic/<traffic>.json``;
* a cell: ``cells/<workload>.json`` (the limits its outputs are held to);
* a metric: ``metrics/<metric>.py``, a reader with ``read(record)``.

So a later change adds a cell, a configuration or a metric by adding files
and entries, and edits no file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
BENCH_DIR = "chipbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict  # the configuration's file
    traffic: Dict  # the mix's file
    limits: Dict  # the cell's file
    bench_dir: Path

    @property
    def family(self) -> str:
        return self.config["family"]


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench_dir = self.root / BENCH_DIR
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> Dict:
        for e in self.data[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    def cell(self, workload: str) -> Cell:
        w = self._entry("workloads", workload)
        conf = self._entry("configs", w["config"])
        return Cell(
            name=workload,
            chips=w["chips"],
            config=json.loads((self.root / conf["file"]).read_text()),
            traffic=json.loads((self.bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
            limits=json.loads((self.bench_dir / "cells" / f"{workload}.json").read_text()),
            bench_dir=self.bench_dir,
        )

    def metrics(self, workload: str, trace: bool) -> List[Dict]:
        """The cell's end-to-end metrics (``trace`` off) or per-layer ones."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[key] if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py", f"metric_{metric}")

    def names(self) -> List[str]:
        """Every name the file defines or refers to."""
        d = self.data
        out = [c["name"] for c in d["configs"]]
        for w in d["workloads"]:
            out += [w["name"], w["config"], w["traffic"]]
        for c in d["configs"]:
            out += list(c["reduced"])
        out += [m["name"] for m in d["end_to_end"] + d["per_layer"]]
        return out


def load_module(path: Path, name: Optional[str] = None):
    spec = importlib.util.spec_from_file_location(name or path.stem.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
