"""Cells, configurations and metrics are found by name; the result line
has the shape that BENCHMARK.json's cells call for."""

import json

import pytest

from portbench import cells, compare, harness
from portbench.netdesc import net_from_layers

BENCH = cells.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = cells.cell(name)
    assert cell["config"] == w["config"]
    assert cell["chips"] == w["chips"]
    assert name == f"{w['config']}.{w['traffic']}"
    cfg = cells.config(cell["config"])
    assert cfg["name"] == w["config"]
    assert set(cell["limits"]) == set(compare.NUMBERS)
    tr = harness.training_params(cfg, cell, 7)
    net = net_from_layers(cells.layers(cfg), tr["BATCH_SZ"],
                          cfg["data"]["img_sz"], cfg["data"]["channels"])
    assert net.batch == tr["BATCH_SZ"]
    assert callable(cells.generator(cfg["data"]["generator"]))
    assert "wgrad" in cells.kernel_map(cell["config"])


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    assert callable(cells.reader(name))


def test_config_entries_point_at_their_files():
    for c in BENCH["configs"]:
        cfg = cells.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["source"] == cfg["source"]
        for key in c["reduced"]:
            assert key in cfg and cfg[key] != cfg["published"][key]


def test_metric_names_follow_trace():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b"}],
             "per_layer": [{"name": "c"}, {"name": "d"}]}
    assert cells.metric_names(bench, False) == ["a", "b"]
    assert cells.metric_names(bench, True) == ["c", "d"]


def test_unknown_cell_stops():
    with pytest.raises(SystemExit):
        cells.cell("no_such.cell")


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_shape(trace, small):
    """A rehearsal on the CPU at a small size: the keys a result line carries,
    the cell's metrics by the trace flag, and the checks last."""
    res = harness.run("mnist_cnn.fused.b20", 2 ** 31 + 99, 0.5, bool(trace),
                      device="cpu")
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = cells.metric_names(BENCH, bool(trace))
    assert set(line["metrics"]) <= set(want)
    if not trace:
        assert set(line["metrics"]) == set(want)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line["checks"]) == list(compare.NUMBERS)
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
