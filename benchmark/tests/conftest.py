"""Fixtures of the benchmark's own tests: a throwaway benchmark root at a
size the CPU runs in seconds, and the card check (made at run time)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

torch.set_num_threads(1)


def small_root(tmp: Path, width=32, height=18, max_steps=256,
               warm=None) -> Path:
    """A copy of the benchmark's data files under ``tmp`` with every mix at
    ``width`` x ``height``, every configuration's step budget cut to
    ``max_steps`` and a 256x128 sky: the CPU's size for the harness's own
    tests (the code is the repository's)."""
    bench = tmp / "benchmark"
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits", "layer_metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, bench / sub)
    for path in (bench / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(width=width, height=height)
        if warm is not None:
            mix.update(warm_frames=warm)
        path.write_text(json.dumps(mix))
    for path in (bench / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["trace"]["max_steps"] = max_steps
        cfg["sky"].update(width=256, height=128)
        path.write_text(json.dumps(cfg))
    return tmp


@pytest.fixture
def cuda():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
