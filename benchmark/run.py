"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as ``setup_s``): imports, the program's scene (the sky made
on the device from the seed, its atlas, the camera), and the mix's warm
frames, which load or build the ray-march kernel's library and warm every
shape the stream uses.  Then the frame loop runs for ``--seconds``; with
``--trace 1`` it runs with spans and ends with a profiled stretch.  Once the
window has closed and the peak memory is read, the program's state is
freed and the plain reference renders the stream's last frame, which the
check compares with the program's.  The last line on stdout is the result
as JSON; the numbers compared, each beside its limit, are the last lines on
stderr.  A run without enough CUDA devices, or that finds JAX or the JAX
package loaded, prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import check, loop, manifest, scene, stats, tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "geodesic_raytracing_tpu")


class TracedRun(NamedTuple):
    """What a per-layer reader reads."""

    frames: list  # tracing.Spans.summary() of the traced window's frames
    profile: object  # tracing.Profile, or None
    launches: list  # the reference's launches of the compared frame
    instance: tuple  # (metric name, planar): the kernel instance launched


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def main(argv=None, *, root: Path = manifest.ROOT, device=None,
         fault=None) -> int:
    """One run.  ``device`` None is the command line's: CUDA, or exit 2.
    Tests pass ``device="cpu"`` and may pass ``fault``, a function that
    takes the program's modules and breaks its timed path."""
    args = parse(argv)
    spec = manifest.load(root)
    cell = manifest.cell(spec, args.workload)
    config = manifest.config(root, spec, cell["config"])
    mix = manifest.mix(root, cell["traffic"])
    limits = manifest.limits(root, cell["name"])

    import torch

    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                  f"found {found}", file=sys.stderr)
            return 2
        device = "cuda"
        # The host only dispatches the frame's CUDA ops: a pool of CPU
        # threads for the few host-side ops competes with that one thread
        # for shared cores and makes the frame period wander.
        torch.set_num_threads(1)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)

    from geodesic_raytracing_tpu_torch.ops import integrate
    from geodesic_raytracing_tpu_torch.render import pipeline

    if fault is not None:
        fault(pipeline, integrate)

    inputs = scene.inputs(config, mix, args.seed, device)
    prog = scene.program(config, mix, inputs, device)
    W, H = mix["width"], mix["height"]

    spans = tracing.Spans(device) if args.trace else None
    render = functools.partial(prog.render, device)
    stream = loop.FrameStream(spans.frame(render) if spans else render,
                              (H, W, 3), mix["in_flight"], device)
    for _ in range(mix["warm_frames"]):
        stream.step()
    stream.drain()
    if spans:
        spans.frames.clear()
    setup_s = time.perf_counter() - T0

    start = time.perf_counter()
    deadline = start + args.seconds
    with spans.trace_rays(integrate) if spans else contextlib.nullcontext():
        while time.perf_counter() < deadline:
            stream.step()
        stream.drain()
    window_frames = spans.summary() if spans else None
    done = stats.window(stream.done, start, deadline)
    attempted = sum(1 for d in stream.done if d.dispatched >= start)
    profile = None
    if spans:
        profile = tracing.profile(stream, Path(root) / "build" / "benchmark"
                                  / f"trace_{cell['name']}.json")
    image = stream.last_image()
    index = stream.count
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    del stream, render, prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    from benchmark.reference import frame as rframe

    metric, params, settings, backgrounds, camera = scene.reference(
        config, mix, inputs, device)
    t_ref = time.perf_counter()
    ref, launches = rframe.render(metric, params, settings, backgrounds,
                                  *camera, index=index)
    print(f"frames {len(done)} in the window of {attempted} dispatched; "
          f"frame {index} compared; reference {time.perf_counter() - t_ref:.1f}"
          " s", file=sys.stderr)
    numbers = check.compare(image.to(device), ref)
    correct = check.judge(numbers, limits)

    if args.trace:
        run = TracedRun(window_frames, profile, launches,
                        (config["metric"], rframe._planar(metric, settings)))
        metrics = {}
        for m in manifest.metrics_of(spec["per_layer"], cell["name"]):
            value = manifest.reader(root, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"mrays_per_s": stats.mrays_per_s(done, W * H, start),
               "frame_ms_p90": 1e3 * stats.p90([d.latency_s for d in done]),
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in manifest.metrics_of(spec["end_to_end"],
                                                cell["name"])}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted,
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": dev}
    if profile is not None and profile.busy_s > 0:
        dev.update(busy_s=profile.busy_s, window_s=profile.window_s)
        result["breakdown"] = {"device_ops": profile.device_ops,
                               "idle_gaps": profile.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()}
    found = forbidden_modules()
    if found:
        print(f"loaded in the run's process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, v in numbers.items():
        print(f"check {k} = {v!r} (limit {limits[k]!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
