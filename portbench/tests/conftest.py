"""Shared fixtures of the benchmark's CPU tests: the checkout's packages on
the path, and a copy of the benchmark whose cells run at smoke size.

Run them from the root of a checkout:
``python -m pytest -q -p no:cacheprovider portbench/tests``."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# each configuration's family at a size the CPU runs in seconds: every
# width cut, the structure (GQA, q/k norm, tied unembedding; the SSD's
# chunks) kept
SMOKE = {
    "dense": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=256),
    "ssm": dict(num_layers=2, d_model=64, vocab_size=256,
                ssm=dict(state_dim=16, head_dim=16, expand=2, conv_width=4,
                         chunk=16)),
}
SMOKE_SEQ = {"long-1x4096": 64, "short-8x512": 32}


def copy_benchmark(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``portbench/`` under ``dest``."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def shrink(root: Path) -> Path:
    """Every configuration of the copy at ``root`` cut to its family's
    smoke size with its cut after layer 1, every mix to short rows."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        f = root / c["file"]
        cfg = json.loads(f.read_text())
        cfg["port"].update(SMOKE[cfg["port"]["family"]])
        cfg["deployment"]["static_op"] = 1
        f.write_text(json.dumps(cfg))
    for name, seq in SMOKE_SEQ.items():
        f = root / "portbench" / "traffic" / f"{name}.json"
        mix = json.loads(f.read_text())
        mix["seq"] = seq
        f.write_text(json.dumps(mix))
    return root


@pytest.fixture
def smoke_root(tmp_path):
    import torch
    torch.set_num_threads(1)
    return shrink(copy_benchmark(tmp_path))


def cells():
    return [w["name"] for w in
            json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
