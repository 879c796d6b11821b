"""Finding a cell's parts by name.

``BENCHMARK.json`` (at the checkout's root) names the cells and metrics;
everything that belongs to one of them sits in a file of its own, found by
its name:

  * ``configs/<config>.json``: the configuration as it is run (the
    ``.prms`` layer list and training params, the data generator and its
    sizes, the source and what was changed from it);
  * ``workloads/<cell>.json``: the cell's config, its overrides of the
    training params (batch, test interval, eval window), its chips, the
    periods its traced run profiles and the limits of its comparison;
  * ``metrics/<metric>.py``: one reader a metric, ``read(ctx)`` -> a number
    or None (nothing to read);
  * ``kernels/<config>.json``: which kernel names make up a stage;
  * ``data/<generator>.py``: a data generator;
  * ``peaks.json``: the chips' published peaks.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return _json(ROOT / "BENCHMARK.json")


def cell(name):
    path = HERE / "workloads" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"portbench: no cell {name!r} ({path} is missing)")
    return _json(path)


def config(name):
    return _json(HERE / "configs" / f"{name}.json")


def kernel_map(config_name):
    path = HERE / "kernels" / f"{config_name}.json"
    return _json(path) if path.exists() else {}


def peaks(kind):
    """The peaks of the chip whose name ``kind`` starts with a key of
    peaks.json (e.g. 'NVIDIA H100 80GB HBM3' -> 'NVIDIA H100')."""
    table = _json(HERE / "peaks.json")
    for key, row in table.items():
        if kind.startswith(key):
            return row
    raise SystemExit(f"portbench: no peaks for {kind!r} in peaks.json")


def generator(name):
    return importlib.import_module(f"portbench.data.{name}").make


def layers(cfg):
    """The config's layer list as the ``.prms`` loader gives it: [name,
    dict] pairs with fresh dicts (the net builder edits them)."""
    return [[name, dict(args)] for name, args in cfg["layers"]]


def metric_names(bench, trace):
    """A cell's metrics, in BENCHMARK.json's order: the end-to-end metrics
    with ``trace`` 0, the per-layer metrics with 1 (every cell reports
    every metric)."""
    return [m["name"] for m in bench["per_layer" if trace else "end_to_end"]]


def reader(name):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
