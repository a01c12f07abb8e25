"""Where a run's step time goes on the GPU: device time by kernel, from a
``torch.profiler`` trace of steady steps.

    python -m jaybenne_tpu_torch.profile -i DECK [--warm N] [--steps M]
        [--trace PATH] [--eager] [--rounds-per-batch R] [block/key=value ...]

Builds the ``Simulation`` on the GPU, runs ``--warm`` steps, times ``--steps`` more
on the host clock (each step ends in ``torch.cuda.synchronize()``), then restores
the state from before them and runs the same steps again under
``torch.profiler`` (the random streams are keyed by seed and cycle, so they are
the same steps), and sums the trace's device events (kernels, copies, memsets) by
name. It prints one line per name with its device time per step, the device
total per step, the median wall time of the unprofiled steps and the device's
idle share of them, the census kernel's launches by instantiation and route
(``transport_{1,2,3}d[_abs][_ddmc][_smr][_ng][@z|@blocks]``, from
``cuda_lib.LAUNCHES``) in the profiled steps, the migration rounds of each step
under the spatial decomposition, the host's synchronisations with the device per
step (the same steps once more under ``torch.cuda.set_sync_debug_mode``, each
synchronising call counted: ``host_syncs``), the host and device milliseconds a
step of each ``record_function`` span (the spatial step's head, rounds and their
fixup, census and migration, exit reads and tail: ``spans_by_name``; the
DDMC face probabilities, ``step.face_probs``) and the device work queued inside each
span by name (``span_kernels``: in an eager step, a span's own work), and
``nvidia-smi``'s card name and power limit. The step runs as the driver runs it
(CUDA graphs where it can: the first step eagerly, the second captured, so give
``--warm`` at least 2 to time replays), or eagerly with ``--eager``.
``--rounds-per-batch`` sets the spatial step's rounds a batch (by default
``spatial.ROUNDS_PER_BATCH`` as CUDA graphs, one eagerly). ``read_steps`` is the
reading, for a ``Simulation`` built elsewhere.
``--trace`` also writes the Chrome trace. Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import warnings

import torch

from . import config as config_mod
from .driver import Simulation
from .ops import cuda_lib
from .utils.deck import Deck

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_time_by_name(trace_path: str) -> dict:
    """Microseconds of device time per event name in a Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = collections.Counter()
    for e in events:
        if e.get("cat") in _DEVICE_CATS and "dur" in e:
            out[e["name"]] += float(e["dur"])
    return dict(out)


def spans_by_name(trace_path: str) -> tuple:
    """Milliseconds of host time (``user_annotation``) and of device time
    (``gpu_user_annotation``: from the first kernel to the last one queued in
    the span) per ``record_function`` span name in a Chrome trace, and each
    span's count."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    host, dev, count = collections.Counter(), collections.Counter(), collections.Counter()
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e:
            host[e["name"]] += float(e["dur"]) / 1e3
            count[e["name"]] += 1
        elif e.get("cat") == "gpu_user_annotation" and "dur" in e:
            dev[e["name"]] += float(e["dur"]) / 1e3
    return dict(host), dict(dev), dict(count)


def span_kernels(trace_path: str) -> dict:
    """Microseconds of device time by event name (kernels, copies, memsets) that
    start inside each ``record_function`` span's device interval
    (``gpu_user_annotation``), per span name: in an eager step, the device work
    the span queued, without the gaps between it."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "gpu_user_annotation" and "dur" in e]
    out = collections.defaultdict(collections.Counter)
    for e in events:
        if e.get("cat") in _DEVICE_CATS and "dur" in e:
            for name, a, b in spans:
                if a <= e["ts"] < b:
                    out[name][e["name"]] += float(e["dur"])
    return {name: dict(v) for name, v in out.items()}


def host_syncs(sim, steps: int) -> int:
    """The host's synchronisations with the device in ``steps`` steps of ``sim``
    (``Simulation.run``): each call that ``torch.cuda.set_sync_debug_mode("warn")``
    reports, the driver's one synchronisation a step among them, and each spatial
    batch's exit read (``spatial._exit_read``, counted as one whether it reads the
    device tensor or waits on the event of its pinned copy, which the mode does
    not see)."""
    from .parallel import spatial

    reads, real = [0], spatial._exit_read

    def counted(count):
        reads[0] += 1
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(count)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    spatial._exit_read = counted
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sim.run(nlim=steps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        spatial._exit_read = real
    return sum("synchroniz" in str(w.message) for w in caught) + reads[0]


def read_steps(sim, steps: int, trace=None) -> dict:
    """``steps`` steps of ``sim`` (``Simulation``, on a GPU) timed on the host clock,
    the same steps again from a snapshot under ``torch.profiler``, and once more
    counting the host's synchronisations; ``sim``'s state ends where the timed
    steps left it (its history holds the reruns too). Returns the unprofiled
    steps' walls (s), events and migration rounds, the profiled steps' launches
    (``cuda_lib.LAUNCHES``), device
    microseconds by name (``device_time_by_name``), spans (``spans_by_name``:
    host ms, device ms, count) and their device work (``span_kernels``), and the
    synchronisations. ``trace``: write the Chrome trace there too."""
    n0 = len(sim.history)
    snapshot = sim.snapshot()
    sim.run(nlim=steps)
    hist = sim.history[n0:]
    out = {"wall_s": [h["step_seconds"] for h in hist], "events": [h["events"] for h in hist],
           "rounds": [h["migration_rounds"] for h in hist]}
    if len(hist) != steps:
        raise RuntimeError(f"profile: ran {len(hist)} timed steps of {steps} (tlim reached?)")
    sim.restore(snapshot)
    n1 = len(sim.history)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = collections.Counter(cuda_lib.LAUNCHES)
    with torch.profiler.profile(activities=acts) as prof:
        sim.run(nlim=steps)
    out["launches"] = dict(collections.Counter(cuda_lib.LAUNCHES) - before)
    if [h["events"] for h in sim.history[n1:]] != out["events"]:
        raise RuntimeError("profile: the profiled steps differ from the timed ones")
    sim.restore(snapshot)
    out["syncs"] = host_syncs(sim, steps)
    with tempfile.TemporaryDirectory() as tmp:
        path = trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        out["by_name"] = device_time_by_name(path)
        out["spans"] = spans_by_name(path)
        out["in_spans"] = span_kernels(path)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None, help="also write the Chrome trace here")
    ap.add_argument("--eager", action="store_true", help="run the eager step, no graph")
    ap.add_argument("--rounds-per-batch", type=int, default=None,
                    help="the spatial step's rounds a batch")
    ap.add_argument("overrides", nargs="*", metavar="block/key=value")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: needs a GPU", file=sys.stderr)
        return 1
    mods = dict(ov.split("=", 1) for ov in args.overrides)
    cfg = config_mod.from_deck(Deck.from_file(args.input).update(mods))
    with tempfile.TemporaryDirectory() as outdir:
        sim = Simulation(cfg, outdir=outdir, quiet=True, device="cuda", graph=not args.eager,
                         rounds_per_batch=args.rounds_per_batch)
        sim.run(nlim=args.warm)
        r = read_steps(sim, args.steps, args.trace)
    wall, rounds, launches, syncs = r["wall_s"], r["rounds"], r["launches"], r["syncs"]
    by_name, in_spans = r["by_name"], r["in_spans"]
    span_host, span_dev, span_count = r["spans"]
    n = args.steps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    total = sum(by_name.values()) / n
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
        print(f"device_ms_per_step {us / n / 1e3!r} {name[:120]}")
    for name in sorted(span_host):
        print(f"span {name}: host_ms_per_step {span_host[name] / n!r} device_ms_per_step "
              f"{span_dev.get(name, 0.0) / n!r} count_per_step {span_count[name] / n!r}")
        inside = sorted(in_spans.get(name, {}).items(), key=lambda kv: -kv[1])
        print(f"span {name}: its device work {sum(us for _, us in inside) / n / 1e3!r} ms per "
              "step, by name: " + "; ".join(f"{us / n / 1e3!r} {k[:80]}" for k, us in inside))
    step_ms = statistics.median(wall) * 1e3
    core = getattr(sim.step_fn, "step", sim.step_fn)
    print(f"step: {'CUDA graphs' if sim.graphed else 'eager'}"
          + (f", {core.rounds_per_batch} rounds a batch"
             + (", the next queued before a batch's exit read" if core.ahead else "")
             if sim.spatial else ""))
    print(f"launches in the profiled steps: {launches}")
    print(f"migration rounds per step: {rounds}; host synchronisations per step: "
          f"{syncs / n!r}")
    print(f"device total {total / 1e3!r} ms per step; unprofiled step wall median "
          f"{step_ms!r} ms over {n}; device idle share {1.0 - total / 1e3 / step_ms!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
