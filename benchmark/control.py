"""The readings that the check's limits are set from, for one cell.

    python3 benchmark/control.py --workload <cell> --frames <n> \
        --seeds <s1> <s2> ...

For each seed: the program renders a stream of ``--frames`` frames through
the benchmark's frame loop (untimed), the plain reference renders the last
of them, and the control renders it too: the reference put in the
program's place with every march in bfloat16, the precision below the
float32 that the configurations state.  One JSON line a seed gives the
check's numbers of the program (``program``, the lower readings) and of
the control (``control``, the upper readings) against the reference.  Not
part of a benchmark run; run on the card at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import check, loop, manifest, scene  # noqa: E402
from benchmark.reference import frame as rframe  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def readings(root: Path, cell_name: str, seed: int, frames: int,
             device) -> dict:
    """``{"program": numbers, "control": numbers}`` of one seed."""
    spec = manifest.load(root)
    cell = manifest.cell(spec, cell_name)
    config = manifest.config(root, spec, cell["config"])
    mix = manifest.mix(root, cell["traffic"])
    inputs = scene.inputs(config, mix, seed, device)
    out = {"seed": seed, "frames": frames}
    prog = scene.program(config, mix, inputs, device)
    stream = loop.FrameStream(lambda: prog.render(device),
                              (mix["height"], mix["width"], 3),
                              mix["in_flight"], device)
    for _ in range(frames):
        stream.step()
    stream.drain()
    image = stream.last_image().to(device)
    del stream, prog
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref_scene = scene.reference(config, mix, inputs, device)
    t0 = time.perf_counter()
    ref, _ = rframe.render(*ref_scene[:4], *ref_scene[4], index=frames)
    out["reference_s"] = time.perf_counter() - t0
    out["program"] = check.compare(image, ref)
    t0 = time.perf_counter()
    ctl, _ = rframe.render(*ref_scene[:4], *ref_scene[4], index=frames,
                           dtype=CONTROL_DTYPE)
    out["control_s"] = time.perf_counter() - t0
    out["control"] = check.compare(ctl, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(manifest.ROOT, args.workload, seed,
                                  args.frames, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
