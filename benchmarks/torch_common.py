"""Shared utilities of the port's benchmarks (the counterpart of
`benchmarks/common.py`, which imports JAX).

Prints the same ``name,us_per_call,derived`` CSV rows and keeps them in
`RESULTS` (name -> us_per_call) for `write_json`.
"""
import json
import math
import os
import time

import torch

RESULTS = {}


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, warmup=2, iters=10):
    """Median wall time per call in microseconds. The device is
    synchronised after every call (warmup calls excluded from the
    median), so a call's time covers its device work."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def emit(name, us, derived=""):
    RESULTS[name] = us
    print(f"{name},{us:.1f},{derived}", flush=True)


def finite(results=None) -> bool:
    """Every emitted value is a finite number."""
    return all(math.isfinite(v) for v in (RESULTS if results is None else results).values())


def device_label(device) -> str:
    """The device a run measured: the card's name, or ``cpu``."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def write_json(path="BENCH_torch.json"):
    """Machine-readable mirror of the CSV: {name: us_per_call}."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(RESULTS, f, indent=1, sort_keys=True)
    print(f"# wrote {path} ({len(RESULTS)} entries)")
    return path
