"""The benchmark's definitions, found by name under ``perfbench/``."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent          # perfbench/
REPO = ROOT.parent
BENCHMARK = REPO / "BENCHMARK.json"

# keys a metric reader module declares
READER_KEYS = ("LAYER", "UNIT", "BETTER", "SOURCE", "MOVES", "WORKLOADS")
# what an entry module (``entries/<name>.py``) provides
ENTRY_KEYS = ("STAGE_MARKS", "prepare", "instrument", "serve")
# what a family module (``families/<name>.py``) provides (``families/gpt_sovits_v2.py``'s
# docstring says what each is)
FAMILY_KEYS = ("models", "port_init", "init_rule", "character", "sv_fn", "derived", "Check",
               "output_rate", "samples_per_code", "tiny")
FAMILIES = ROOT / "families"


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict            # the mix's parameters, the cell's overrides applied
    chips: int
    why: str
    limits: Dict[str, float]  # each number the check compares, and its limit
    end_to_end: List[Dict]   # BENCHMARK.json entries this cell reports
    per_layer: List[Dict]


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text(encoding="utf-8"))


def benchmark() -> Dict:
    if not BENCHMARK.is_file():
        raise SystemExit(f"{BENCHMARK} is missing")
    return load_json(BENCHMARK)


def config(name: str) -> Dict:
    cfg = load_json(ROOT / "configs" / f"{name}.json")
    cfg.setdefault("name", name)
    if "family" not in cfg:
        raise SystemExit(f"configs/{name}.json names no family: give it \"family\", the "
                         f"module of families/ that makes its weights, builds its system "
                         f"and checks its output")
    return cfg


def traffic(name: str) -> Dict:
    return load_json(ROOT / "traffic" / f"{name}.json")


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[Dict] = None) -> Cell:
    """The cell ``name``: its file under ``workloads/``, its configuration
    and mix, and the metrics BENCHMARK.json has it report."""
    bench = benchmark() if bench is None else bench
    wl = load_json(ROOT / "workloads" / f"{name}.json")
    entry = next((w for w in bench.get("workloads", []) if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"workload {name!r} is not in BENCHMARK.json")
    for key in ("config", "traffic", "chips"):
        if entry[key] != wl[key]:
            raise SystemExit(f"workload {name!r}: {key} is {wl[key]!r} in its file "
                             f"and {entry[key]!r} in BENCHMARK.json")
    mix = dict(traffic(wl["traffic"]))
    mix.update(wl.get("params", {}))
    return Cell(name=name, config=config(wl["config"]), traffic=mix, chips=wl["chips"],
                why=entry["why"], limits=wl["limits"],
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


_MODULES: Dict[Path, object] = {}


def _module(kind: str, name: str, where: Optional[Path] = None):
    """``<kind>/<name>.py`` under ``perfbench/`` (or ``<name>.py`` under
    ``where``), loaded once a process."""
    path = (where or ROOT / kind) / f"{name}.py"
    if path not in _MODULES:
        if not path.is_file():
            raise SystemExit(f"{kind}/{name}.py is missing")
        spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(metric: str):
    """The reader module of a per-layer metric (``metrics/<name>.py``):
    its ``read(records) -> float | None`` and the keys of
    :data:`READER_KEYS`."""
    mod = _module("metrics", metric)
    missing = [k for k in READER_KEYS if not hasattr(mod, k)] + (
        [] if hasattr(mod, "read") else ["read"])
    if missing:
        raise SystemExit(f"metrics/{metric}.py lacks {missing}")
    return mod


def readers() -> Dict[str, object]:
    """Every reader under ``metrics/``, by metric name."""
    return {p.stem: reader(p.stem) for p in sorted((ROOT / "metrics").glob("*.py"))}


def entry(name: str):
    """The entry a mix drives (``entries/<name>.py``): ``STAGE_MARKS``,
    ``prepare(system, requests, serve, log)``, ``instrument(system,
    current) -> undo`` and ``serve(system, request, phones, bert, kw,
    stages) -> pieces``; optionally ``system``, the system under test it
    builds itself (with the arguments of :class:`.system.System`)."""
    mod = _module("entries", name)
    missing = [k for k in ENTRY_KEYS if not hasattr(mod, k)]
    if missing:
        raise SystemExit(f"entries/{name}.py lacks {missing}")
    return mod


def family(name: str):
    """The module of a model family (``families/<name>.py``, under
    :data:`FAMILIES`), which a configuration names: the keys of
    :data:`FAMILY_KEYS`."""
    mod = _module("families", name, FAMILIES)
    missing = [k for k in FAMILY_KEYS if not hasattr(mod, k)]
    if missing:
        raise SystemExit(f"families/{name}.py lacks {missing}")
    return mod


def work(name: str):
    """The operation and byte counts of a model family (``work/<name>.py``)."""
    return _module("work", name)
