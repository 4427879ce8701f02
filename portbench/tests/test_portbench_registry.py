"""BENCHMARK.json against its contract, each name resolving to its files,
and a configuration, a mix and a metric added as files alone."""
import json
import re

import pytest

from conftest import ROOT, copy_benchmark

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_limits_of_the_file():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    from portbench import check, registry
    c = registry.load_cell(cell)
    fam = registry.family(c.config["port"]["family"])
    for fn in ("init", "loss", "matmul_params", "mixer_work"):
        assert callable(getattr(fam, fn))
    assert registry.kernel_names(fam.KERNELS)
    assert c.limits and set(c.limits) <= set(check.NAMES)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(registry.metric_reader(m["name"]).read)
    for key in ("clients", "local_steps", "rows_per_step", "seq",
                "test_rows"):
        assert int(c.traffic[key]) > 0


def test_every_config_is_used_and_sourced():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["dtype"] == "float32" and cfg["tf32"] is False


def test_files_added_alone_are_found(tmp_path):
    """A throwaway configuration, mix, metric, kernel family and cell,
    added as files and entries in a copy, resolve with no code edited."""
    from portbench import registry
    root = copy_benchmark(tmp_path)
    here = root / "portbench"
    cfg = json.loads((here / "configs/qwen3-0.6b.json").read_text())
    cfg["port"]["num_layers"] = 4
    (here / "configs/throwaway.json").write_text(json.dumps(cfg))
    (here / "traffic/throwaway-2x256.json").write_text(json.dumps(
        {"clients": 2, "local_steps": 1, "rows_per_step": 2, "seq": 256,
         "test_rows": 2}))
    (here / "metrics/throwaway_rate.py").write_text(
        "def read(reading):\n    return 42.0\n")
    (here / "kernels/throwaway").mkdir()
    (here / "kernels/throwaway/some_kernel.txt").write_text("some_kernel\n")
    (here / "limits/throwaway-cell.json").write_text(json.dumps(
        {"loss_gap": 1, "round0_loss_gap": 1, "eval_gap": 1,
         "update_gap": 1, "change_gap": 1}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway", "source": "nowhere",
                             "file": "portbench/configs/throwaway.json",
                             "reduced": ["num_hidden_layers"], "why": "x"})
    bench["workloads"].append({"name": "throwaway-cell",
                               "config": "throwaway",
                               "traffic": "throwaway-2x256", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "throwaway_rate", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "train_tokens_per_s",
                               "workloads": ["throwaway-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = registry.load_cell("throwaway-cell", root)
    assert c.config["port"]["num_layers"] == 4
    assert c.traffic["seq"] == 256
    assert [m["name"] for m in c.per_layer if m["name"] == "throwaway_rate"]
    assert registry.metric_reader("throwaway_rate", root).read(None) == 42.0
    assert registry.kernel_names("throwaway", root) == ["some_kernel"]
    # a metric without a workloads key reaches every cell, the new one too
    assert {m["name"] for m in c.end_to_end} == {
        m["name"] for m in bench["end_to_end"]
        if "throwaway-cell" in m.get("workloads", ["throwaway-cell"])}
