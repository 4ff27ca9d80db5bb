"""Where a lockstep step's time goes on the card.

    python -m ra_tpu_torch.step_profile                # single steps
    python -m ra_tpu_torch.step_profile --superstep 8  # K = 8 a dispatch

Drives the main-path engine (CounterMachine, 10,000 lanes x 5 members,
ring 1024, 128 commands a lane a step, write_delay 1) on CUDA and prints
one JSON line: the card (name and power limit from nvidia-smi), the
untraced ms per step, and from a ``torch.profiler`` trace per step the
device-busy ms of the dispatch stream (kernels and device-to-device
copies) and apart from it the kernels' ms and the host-to-device copies'
ms (on the copy engines, overlapping the kernels), the device idle
share against the busy ms, device kernels per step, the items that take
the most device time, and the fused commit-phase kernel's time a
launch.

Single steps (``uniform_step(128)``): also the torch ops one step issues
on the host (all, and those that are not views).

``--superstep K``: the superstep path through ``DispatchAheadDriver``
(two dispatches in flight) fed host numpy blocks of K x 128 commands a
lane; each dispatch replays one captured CUDA graph.  The numbers are
per inner step, plus device kernels a dispatch and host time a
dispatch: the time ``submit`` works on the host (staging the next block
and issuing this one), and apart from it the time it waits at window
boundaries for the device.

A trace with no device time prints "not measured" for the device
numbers.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from .engine import DispatchAheadDriver, LockstepEngine
from .models import CounterMachine

LANES, CMDS, TRACED_STEPS = 10_000, 128, 20


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside it: ``ops`` all of them,
    ``views`` those whose result aliases an input."""

    def __init__(self):
        super().__init__()
        self.ops = self.views = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.views += any(r.alias_info is not None and
                          not r.alias_info.is_write
                          for r in func._schema.returns)
        return func(*args, **(kwargs or {}))


def device_rows(prof) -> dict:
    """The device rows of a ``torch.profiler`` trace in three groups:
    ``kernels``; ``copies``, the device-to-device copies and memsets,
    which run in order with the kernels on the dispatch stream; and
    ``transfers``, the copies between host and card, which run on the
    copy engines beside the kernels and so are not the stream's busy
    time."""
    out: dict = {"kernels": [], "copies": [], "transfers": []}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.self_device_time_total <= 0:
            continue
        group = ("transfers" if e.key.startswith(("Memcpy HtoD",
                                                  "Memcpy DtoH"))
                 else "copies" if e.key.startswith(("Memcpy", "Memset"))
                 else "kernels")
        out[group].append(e)
    return out


def _ms(rows) -> float:
    return sum(e.self_device_time_total for e in rows) / 1e3


def traced(run, steps: int, dispatches: int, untraced_ms: float) -> dict:
    """Profile ``run()`` (``steps`` inner steps in ``dispatches``
    dispatches, ending in a synchronize) and read the device numbers per
    inner step from the trace.  Device busy is the dispatch stream's:
    kernels and device-to-device copies, not the host-to-device copies
    that overlap them."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        traced_ms = (time.perf_counter() - t0) / steps * 1e3
    groups = device_rows(prof)
    rows = groups["kernels"] + groups["copies"]
    busy_ms = _ms(rows) / steps
    out = {"traced_ms_per_step": traced_ms, "traced_steps": steps}
    if busy_ms <= 0:
        out["device_busy_ms_per_step"] = "not measured"
        return out
    kernels = sum(e.count for e in groups["kernels"])
    out.update({
        "device_busy_ms_per_step": busy_ms,
        "kernel_ms_per_step": _ms(groups["kernels"]) / steps,
        "transfer_ms_per_step": _ms(groups["transfers"]) / steps,
        "device_idle_share": 1.0 - busy_ms / traced_ms,
        # the profiler slows the host: the same busy time against the
        # untraced step
        "device_idle_share_untraced": 1.0 - busy_ms / untraced_ms,
        "device_kernels_per_step": kernels / steps,
        "device_kernels_per_dispatch": kernels / dispatches,
        "device_copies_per_dispatch": sum(e.count for e in groups["copies"])
        / dispatches,
        "top_device_ms_per_step": [
            [e.key[:80], e.self_device_time_total / steps / 1e3,
             e.count / steps]
            for e in sorted(rows + groups["transfers"],
                            key=lambda e: -e.self_device_time_total)[:10]],
        "commit_phase_kernel_ms": [
            e.self_device_time_total / e.count / 1e3 for e in rows
            if "commit_phase_kernel" in e.key],
        "commit_phase_kernels": sum(e.count for e in rows
                                    if "commit_phase_kernel" in e.key)})
    return out


def single_step(eng) -> dict:
    for _ in range(20):
        eng.uniform_step(CMDS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        eng.uniform_step(CMDS)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / 100 * 1e3
    with OpCount() as count:
        eng.uniform_step(CMDS)

    def run():
        for _ in range(TRACED_STEPS):
            eng.uniform_step(CMDS)
        torch.cuda.synchronize()

    return {"mode": "step", "ms_per_step": plain_ms,
            "host_ops_per_step": count.ops,
            "host_ops_not_views_per_step": count.ops - count.views,
            **traced(run, TRACED_STEPS, TRACED_STEPS, plain_ms)}


def superstep(eng, k: int) -> dict:
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    n_blk = np.broadcast_to(np.full(LANES, CMDS, np.int32), (k, LANES))
    p_blk = np.broadcast_to(np.ones((LANES, CMDS, 1), np.int32),
                            (k, LANES, CMDS, 1))
    for _ in range(3):                 # the first captures the graph
        drv.submit(n_blk, p_blk)
    drv.drain()
    torch.cuda.synchronize()
    dispatches = max(2, 160 // k)
    host_s, wait0 = 0.0, drv.window_wait_s
    t0 = time.perf_counter()
    for _ in range(dispatches):
        t1 = time.perf_counter()
        drv.submit(n_blk, p_blk)
        host_s += time.perf_counter() - t1
    drv.drain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / (dispatches * k) * 1e3
    traced_dispatches = max(2, TRACED_STEPS // k)

    def run():
        for _ in range(traced_dispatches):
            drv.submit(n_blk, p_blk)
        drv.drain()
        torch.cuda.synchronize()

    out = {"mode": "superstep", "superstep_k": k, "ms_per_step": plain_ms,
           "timed_dispatches": dispatches,
           # submit's own work, and its waits at window boundaries
           "host_ms_per_dispatch": (host_s - drv.window_wait_s + wait0) /
           dispatches * 1e3,
           "window_wait_ms_per_dispatch": (drv.window_wait_s - wait0) /
           dispatches * 1e3,
           "window_syncs": eng.pipeline_counters["window_syncs"],
           **traced(run, traced_dispatches * k, traced_dispatches,
                    plain_ms)}
    drv.close()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--superstep", type=int, default=0, metavar="K",
                    help="profile K-step dispatches through the driver")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    eng = LockstepEngine(CounterMachine(), LANES, 5, ring_capacity=1024,
                         max_step_cmds=CMDS, apply_window=CMDS + 2,
                         write_delay=1, device="cuda")
    out = {"card": card.stdout.strip().splitlines()[0], "lanes": LANES,
           "members": 5}
    out.update(superstep(eng, args.superstep) if args.superstep
               else single_step(eng))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
