"""``BENCHMARK.json`` and the files it names, found by name.

  - a configuration ``<c>`` is ``configs/<c>.json`` (the ``file`` its entry
    gives), a deployment's settings, gate and limits;
  - a traffic mix ``<t>`` is ``traffic/<t>.json``, parameters that one
    general runner, ``runners/<runner>.py``, reads;
  - a per-layer metric ``<m>`` is ``metrics/<m>.py``, a reader with
    ``read(run) -> float | None``.

Adding a configuration, a mix or a metric is adding its file and its entry;
no file of the harness changes.  ``validate`` holds a manifest to the rules
the benchmark keeps (names, units, every per-layer metric's cells report
its ``moves`` metric, at most a quarter of the cells on four chips).
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # perfbench/
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(manifest: dict, root: Path, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(bench_dir: Path, name: str) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(bench_dir: Path, name: str):
    return _module(bench_dir / "runners" / f"{name}.py", f"perfbench_runner_{name}")


def metric_reader(bench_dir: Path, name: str):
    return _module(bench_dir / "metrics" / f"{name}.py",
                   "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))


def metrics_of(manifest: dict, cell: str, kind: str) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics cell ``cell`` reports."""
    e2e = {m["name"] for m in manifest["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    if kind == "end_to_end":
        return [m for m in manifest["end_to_end"] if m["name"] in e2e]
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def validate(manifest: dict, root: Path) -> list[str]:
    """Every rule the manifest breaks, as a sentence; empty when sound."""
    errs = []
    if set(manifest) != TOP_KEYS:
        errs.append(f"top-level keys {sorted(manifest)} are not {sorted(TOP_KEYS)}")
        return errs
    seen: dict[str, set] = {"configs": set(), "workloads": set(), "metrics": set()}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = seen["metrics" if kind in ("end_to_end", "per_layer") else kind]
        for e in manifest[kind]:
            n = e.get("name", "")
            if not NAME_RE.match(n):
                errs.append(f"{kind}: bad name {n!r}")
            if n in names:
                errs.append(f"{kind}: duplicate name {n!r}")
            names.add(n)
    cfg_names = {c["name"] for c in manifest["configs"]}
    cells = manifest["workloads"]
    for c in manifest["configs"]:
        if not (root / c["file"]).is_file():
            errs.append(f"config {c['name']}: no file {c['file']}")
        for k in c["reduced"]:
            if not NAME_RE.match(k):
                errs.append(f"config {c['name']}: bad reduced key {k!r}")
        if not any(w["config"] == c["name"] for w in cells):
            errs.append(f"config {c['name']} is used by no cell")
    pairs = set()
    for w in cells:
        if w["config"] not in cfg_names:
            errs.append(f"cell {w['name']}: unknown config {w['config']!r}")
        if not NAME_RE.match(w["traffic"]):
            errs.append(f"cell {w['name']}: bad traffic name {w['traffic']!r}")
        elif not (HERE / "traffic" / f"{w['traffic']}.json").is_file():
            errs.append(f"cell {w['name']}: no traffic file for {w['traffic']!r}")
        if (w["config"], w["traffic"]) in pairs:
            errs.append(f"cell {w['name']}: configuration and traffic repeat")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            errs.append(f"cell {w['name']}: chips {w['chips']} is not 1 or 4")
        if not 1 <= len(w["why"]) <= 200 or "\n" in w["why"]:
            errs.append(f"cell {w['name']}: why must be one line of 1-200 characters")
    four = sum(w["chips"] == 4 for w in cells)
    if four > max(1, len(cells) // 4):
        errs.append(f"{four} of {len(cells)} cells ask for 4 chips (at most a quarter)")
    cell_names = {w["name"] for w in cells}
    e2e_names = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if not UNIT_RE.match(m["unit"]):
            errs.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errs.append(f"metric {m['name']}: better must be lower or higher")
        if m["source"] not in SOURCES:
            errs.append(f"metric {m['name']}: unknown source {m['source']!r}")
        for c in m.get("workloads", []):
            if c not in cell_names:
                errs.append(f"metric {m['name']}: unknown cell {c!r}")
    for m in manifest["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            errs.append(f"end-to-end metric {m['name']}: source must be host_clock or device_trace")
        if not 0.01 <= m["bound"] <= 0.25:
            errs.append(f"end-to-end metric {m['name']}: bound {m['bound']} outside [0.01, 0.25]")
    if "setup_s" not in e2e_names:
        errs.append("no setup_s end-to-end metric")
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e_names:
            errs.append(f"per-layer metric {m['name']}: moves unknown metric {m['moves']!r}")
            continue
        for c in m.get("workloads", []):
            if m["moves"] not in {x["name"] for x in metrics_of(manifest, c, "end_to_end")}:
                errs.append(f"per-layer metric {m['name']}: cell {c} does not report {m['moves']}")
        if not (HERE / "metrics" / f"{m['name']}.py").is_file():
            errs.append(f"per-layer metric {m['name']}: no reader metrics/{m['name']}.py")
    for w in cells:
        e2e = metrics_of(manifest, w["name"], "end_to_end")
        if len(e2e) < 2:
            errs.append(f"cell {w['name']}: needs setup_s and one more end-to-end metric")
        if not metrics_of(manifest, w["name"], "per_layer"):
            errs.append(f"cell {w['name']}: reports no per-layer metric")
    return errs
