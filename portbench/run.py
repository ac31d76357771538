"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic and
limits are found by name from ``BENCHMARK.json`` (or, for a cell parked
until it is steady enough for a bound, ``portbench/parked.json``):
``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<workload>.json`` and one reader
``metrics/<metric>.py`` a metric, all under ``portbench/``.

The run sets up (imports, CUDA context, the scene from the seed, the
cell's warm-up), measures for ``--seconds``, then checks what the window
returned against the plain reference (``portbench/reference/``) and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics, or with ``--trace 1`` the
per-layer ones), ``device`` and, traced, ``breakdown``; then ``checks``,
each compared number with its limit.  No CUDA device, or fewer than the
cell asks for: exit 2 without a result.  JAX loaded by the end: exit 3.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

from . import START, log

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "amrvolumerenderer_tpu", "bench")


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    """``BENCHMARK.json`` with the entries of ``portbench/parked.json``
    that it does not name after its own."""
    out = _json(os.path.join(ROOT, "BENCHMARK.json"))
    parked = _json(os.path.join(HERE, "parked.json"))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = {e["name"] for e in out[key]}
        out[key] = out[key] + [e for e in parked[key] if e["name"] not in names]
    return out


def load_cell(name: str) -> dict:
    """The workload entry ``name`` of the manifest with its configuration,
    traffic, limits and the per-layer and end-to-end metrics it reports."""
    entries = manifest()
    cells = {w["name"]: w for w in entries["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in entries["configs"]}

    def applies(metric):
        return name in metric.get("workloads", [name])

    return dict(
        cell=cell,
        config=_json(os.path.join(ROOT, configs[cell["config"]]["file"])),
        traffic=_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json")),
        limits=_json(os.path.join(HERE, "limits", name + ".json")),
        end_to_end=[m for m in entries["end_to_end"] if applies(m)],
        per_layer=[m for m in entries["per_layer"] if applies(m)],
    )


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(ROOT, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        cell_override: dict = None):
    """Run a cell; returns ``(result dict, checks)``.  ``cell_override``
    (a ``load_cell`` dict) lets tests run a cell of their own size."""
    spec = cell_override or load_cell(workload)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from . import cells
    from .roofline import device_power_limit
    from .trace import Tracer

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < spec["cell"]["chips"]:
            print(f"portbench: needs {spec['cell']['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            raise SystemExit(2)
        torch.cuda.init()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    trace_path = os.path.join(ROOT, "build", "portbench", f"{workload}.{seed}.trace.json.gz")
    tracer = Tracer(trace, trace_path if device == "cuda" else None)
    driver = cells.KINDS[spec["traffic"]["kind"]](spec["config"], spec["traffic"], seed, device,
                                                  tracer)
    tracer.prime()
    driver.setup()
    setup_s = time.perf_counter() - START
    log(f"set up in {setup_s:.2f} s")
    window = driver.window(seconds)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.synchronize()
    driver.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    q = statistics.quantiles(window.durations, n=4) if len(window.durations) > 1 else [0.0] * 3
    log(f"window: {window.attempted} attempted, {window.failed} failed in {window.seconds:.3f} s; "
        f"calls {len(window.durations)}, s a call: quartiles {q[0]:.4f} {q[1]:.4f} {q[2]:.4f}, "
        f"max {max(window.durations):.4f}")
    for key in ("host_prep_ms", "dispatch_ms", "readback_ms"):
        values = [c[key] for c in window.calls]
        if len(values) > 1:
            q = statistics.quantiles(values, n=4)
            log(f"  {key} a call: quartiles {q[0]:.2f} {q[1]:.2f} {q[2]:.2f}, max {max(values):.2f}")
    numbers = driver.check()
    log("checked")
    limits = spec["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    compared = numbers.get("frames_compared", 1.0) > 0
    correct = compared and all(c["value"] <= c["limit"] for c in checks.values()) \
        and window.failed == 0 and window.attempted > 0

    metrics = {}
    extra = {}
    if trace:
        result = tracer.finish()
        ctx = driver.layer_context(window, result)
        for m in spec["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if result is not None:
            extra = {"busy_s": result.busy_s, "window_s": result.window_s}
        log("per-layer metrics read")
    else:
        ctx = SimpleNamespace(window=window, setup_s=setup_s)
        for m in spec["end_to_end"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
               "memory_peak_bytes": int(peak), **extra,
               "power_limit": device_power_limit()}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0, **extra}
    out = {"correct": bool(correct), "attempted": window.attempted, "failed": window.failed,
           "metrics": metrics, "device": dev}
    if trace and tracer.result is not None:
        out["breakdown"] = tracer.result.breakdown()
    out["checks"] = checks
    return out, checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    out, checks = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
