"""Whole runs on the CPU at smoke size: the result line's keys, the
import check, the command without a card, and the faults that the check
must catch, planted in the program underneath the timed path."""
import contextlib
import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, cells


def run(root, cell, traced=False, seed=2 ** 31 + 9):
    from portbench import harness, registry
    return harness.run_cell(registry.load_cell(cell, root), seed, 0.5,
                            traced, "cpu", time.monotonic(),
                            log=lambda *a, **k: None)


@pytest.mark.parametrize("traced", [False, True])
def test_result_keys(smoke_root, traced):
    cell = cells()[0]
    out = run(smoke_root, cell, traced)
    assert list(out)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True
    assert out["attempted"] >= 3 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    from portbench import registry
    c = registry.load_cell(cell)
    want = c.per_layer if traced else c.end_to_end
    for m in want:
        if m["name"] in out["metrics"]:
            assert out["metrics"][m["name"]]["unit"] == m["unit"]
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        for name in ("loop_self_s", "local_train_s", "server_step_ms"):
            assert out["metrics"][name]["value"] > 0
        # the utilisation is over the device's busy time: the CPU's trace
        # holds no device operation, so the reader finds nothing to read
        assert out["device"]["busy_s"] == 0
        assert "step_mfu" not in out["metrics"]
    else:
        assert out["metrics"]["train_tokens_per_s"]["value"] > 0
        assert out["metrics"]["setup_s"]["value"] > 0
    for c_ in out["compared"].values():
        assert set(c_) == {"value", "limit"}
    json.dumps(out)


def test_whole_name_import_check():
    from portbench import harness
    assert harness.forbidden_modules() == []
    assert "repro_torch" in {m.split(".")[0] for m in sys.modules}
    sys.modules["repro"] = sys.modules["portbench"]
    try:
        assert harness.forbidden_modules() == ["repro"]
    finally:
        del sys.modules["repro"]


def test_jax_loaded_after_the_window_prints_no_result(smoke_root, capsys):
    """A metric's reader that loads a module named ``jax`` once the window
    has closed: the run exits 3, names it and prints no result."""
    from portbench import harness, registry
    from portbench import run as command
    (smoke_root / "portbench" / "metrics" / "planted_jax.py").write_text(
        "import sys\nimport types\n\n\ndef read(reading):\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n"
        "    return 1.0\n")
    bench = json.loads((smoke_root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "planted_jax", "unit": "s",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock"})
    (smoke_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.load_cell(cells()[0], smoke_root)
    capsys.readouterr()
    try:
        rc = command.report(lambda: harness.run_cell(
            cell, 2 ** 31 + 11, 0.5, False, "cpu", time.monotonic(),
            log=lambda *a, **k: None))
        assert "jax" in sys.modules
    finally:
        sys.modules.pop("jax", None)
    out, err = capsys.readouterr()
    assert rc == 3
    assert out.strip() == ""
    assert "['jax']" in err


def test_no_card_no_result(tmp_path):
    """Without a card (this machine), and in a directory holding only the
    benchmark's files, the command exits non-zero and prints nothing."""
    from conftest import copy_benchmark
    bare = copy_benchmark(tmp_path)
    for where in (ROOT, bare):
        res = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cells()[0],
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=where, capture_output=True, text=True, timeout=300)
        if torch.cuda.is_available() and where == ROOT:
            continue
        assert res.returncode != 0
        assert res.stdout.strip() == ""


@contextlib.contextmanager
def planted(fault):
    """The program broken underneath the timed path."""
    from repro_torch.data.loader import FleetLoader
    from repro_torch.fl.fleet import SequentialEngine
    from repro_torch.models.split_program import SplitProgram
    from repro_torch.tree import tree_map
    saved = [(SequentialEngine, "run_round", SequentialEngine.run_round),
             (SplitProgram, "loss_through_cut",
              SplitProgram.loss_through_cut),
             (FleetLoader, "next_batch", FleetLoader.next_batch)]
    run_round, loss, next_batch = (s[2] for s in saved)

    def unchanged(engine, params, *args, **kwargs):
        idxs, _ = run_round(engine, params, *args, **kwargs)
        return idxs, [tree_map(lambda v: v.detach().clone(), params)
                      for _ in idxs]

    def half_batch(program, params, batch, op, quantize=False):
        if torch.is_grad_enabled():
            lab = batch["labels"].clone()
            if lab.shape[0] > 1:
                lab[lab.shape[0] // 2:] = -1
            else:
                lab[:, lab.shape[1] // 2:] = -1
            batch = dict(batch, labels=lab)
        return loss(program, params, batch, op, quantize)

    def token(loader, k):
        b = next_batch(loader, k)
        lab = b["labels"].copy()
        lab[0, 0] = (lab[0, 0] + 1) % 256
        return dict(b, labels=lab)
    cls, name = {"unchanged": (SequentialEngine, "run_round"),
                 "half_batch": (SplitProgram, "loss_through_cut"),
                 "token": (FleetLoader, "next_batch")}[fault]
    setattr(cls, name, {"unchanged": unchanged, "half_batch": half_batch,
                        "token": token}[fault])
    try:
        yield
    finally:
        for c, n, f in saved:
            setattr(c, n, f)


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "token"])
def test_a_planted_fault_is_not_correct(smoke_root, cell, fault):
    assert run(smoke_root, cell)["correct"] is True
    with planted(fault):
        out = run(smoke_root, cell)
    assert out["correct"] is False, out["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_control_in_tf32_is_not_correct(cell):
    """The control on the card at the cell's own size: the reference in
    TF32 in the program's place reads beyond a limit."""
    if not torch.cuda.is_available():
        pytest.skip("the control runs on the card: no CUDA device here")
    from portbench import harness, registry
    c = registry.load_cell(cell)
    out = harness.readings(c, 5_000_000_001, ["tf32"], "cuda",
                           log=lambda *a, **k: None)["tf32"]
    assert any(out[name] > limit for name, limit in c.limits.items()), out
