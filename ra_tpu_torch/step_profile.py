"""Where a lockstep step's time goes on the card.

    python -m ra_tpu_torch.step_profile

Drives the main-path engine (CounterMachine, 5 members, ring 1024,
uniform_step(128), write_delay 1) on CUDA, then traces 20 steps with
``torch.profiler`` and prints JSON lines: the card (name and power
limit from nvidia-smi), the untraced ms/step, the torch ops one step
issues on the host (all, and those that are not views), and from the
trace the
device-busy ms/step, the device idle share, device kernels per step and
the kernels that take the most device time, and the fused commit-phase
kernel's time a launch.  A trace with no device time prints "not measured" for the
device numbers.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from .engine import LockstepEngine
from .models import CounterMachine

LANES, TRACED_STEPS = 10_000, 20


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


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    eng = LockstepEngine(CounterMachine(), LANES, 5, ring_capacity=1024,
                         max_step_cmds=128, apply_window=130, write_delay=1,
                         device="cuda")
    for _ in range(20):
        eng.uniform_step(128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        eng.uniform_step(128)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / 100 * 1e3
    with OpCount() as count:
        eng.uniform_step(128)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED_STEPS):
            eng.uniform_step(128)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / TRACED_STEPS * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows) / TRACED_STEPS
    out = {"card": card.stdout.strip().splitlines()[0], "lanes": LANES,
           "members": 5, "ms_per_step": plain_ms,
           "traced_ms_per_step": traced_ms, "traced_steps": TRACED_STEPS,
           "host_ops_per_step": count.ops,
           "host_ops_not_views_per_step": count.ops - count.views}
    if busy_us > 0:
        out.update({
            "device_busy_ms_per_step": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / traced_ms,
            # the profiler slows the host: the same busy time against
            # the untraced step
            "device_idle_share_untraced": 1.0 - busy_us / 1e3 / plain_ms,
            "device_kernels_per_step": sum(e.count for e in rows) /
            TRACED_STEPS,
            "top_device_ms_per_step": [
                [e.key[:80], e.self_device_time_total / TRACED_STEPS / 1e3,
                 e.count // TRACED_STEPS]
                for e in sorted(rows, key=lambda e: -e.self_device_time_total)
                [:10]],
            "commit_phase_kernel_ms": [
                e.self_device_time_total / e.count / 1e3 for e in rows
                if "commit_phase_kernel" in e.key]})
    else:
        out["device_busy_ms_per_step"] = "not measured"
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
