#!/usr/bin/env python3
"""Smoke run of ra_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure raises and exits
non-zero (there is no CPU path and no fallback to a plain version):

  device     the card, and its name and power limit from nvidia-smi
  build      nvcc builds every kernel of ra_tpu_torch/ops/csrc for sm_90a
  kernels    each kernel against its plain torch version on the card at
             the main path's shape and more, exactly: the commit quorum
             (evaluate_quorum, the public API's kernel; ragged 64-lane
             blocks, P = 1..16) and the fused commit phase (commit_phase,
             the step's kernel, every output and dtype); kernel and plain
             version timed with CUDA events, per call (host launch
             included) and back to back in a CUDA graph (device only),
             beside an empty kernel at the kernel's grid (launch floor)
  fold_kernels
             the two in-order fold kernels (slot_fold for registers, KV
             and TTL-KV; fifo_fold under both overflow policies) against
             their plain version, the machine's sequential_window_fold on
             the card, over three chained windows of every op,
             out-of-range keys, negative values and int32 overflow: at
             the paths' full widths and at ragged shapes (N not a
             multiple of the block, P = 1, 3, 5, 7, 16, A = 1, A > Q,
             all-masked and one-command stream windows, 9 groups); for
             the FIFO also the hard windows (fifo_hard_state: full ready
             windows, several rows requeued at once, heads and tickets
             at the int32 edges, equal ranks) with Q = 12, group widths
             8, 16 and 32 and a ring of 5,000 (past 48 KB a block), and
             the consumer mix's window at full ready depth; a strided
             mask; each decoder timed at its path's width, a call and
             back to back, beside its bytes bound and the plain version,
             with the same launch's state load and store alone and its
             command stream alone (what holds it) and the launch floor;
             and on the paths' bench windows the vectorised fast fold
             (the reference's branch there, which the card does not run)
             timed against the kernel, and equal to it
  parity     a seeded 64-step schedule (failures, elections with ties,
             recovery, membership, read batches) on a 1,024 x 5 engine,
             once on cuda and once on cpu: every LaneState leaf and aux
             key equal after every step, one commit_phase launch a step
  main_path  the full-width engine, 10,000 clusters x 5 members, driven
             with uniform_step(128): committed cmds/s and ms/step, then
             exact commit, counter and read_lanes checks; commit_phase
             launched once a step, evaluate_quorum never
  superstep_parity
             K = 8 a dispatch at (1,024 x 5) and (4,099 x 16), ring 16,
             8 cmds, apply window 4 (backpressure): the captured-graph
             superstep against an eager CUDA engine stepped K times and a
             CPU engine, every LaneState leaf and stacked aux key equal
             after every dispatch; elections inside dispatches,
             fail/recover between them, one read block; an aux and a
             state held from one dispatch unchanged by the next
  superstep_path
             the slice at full width: 10,000 x 5 through
             DispatchAheadDriver(max_in_flight=2) fed host numpy blocks
             of K = 8 x 128 commands, a TelemetrySampler attached: 2 warm
             and 25 timed dispatches, ms per inner step, committed
             cmds/s, window syncs, peak memory and the transfer ledger a
             dispatch; exact commits, counter, read_lanes and sampler
             total; no graph capture in the timed window; commit_phase
             executions counted by name in a torch.profiler window equal
             to its inner steps; and K = 1 through the same driver
  wal_disk   the WAL plane alone on build/'s filesystem (its type and free
             space, native or Python I/O, MB/s, fsync p50 and records per
             fsync: ra_tpu_torch/wal_probe.py)
  durable_parity
             durable engines (open_engine, 2 WAL shards, real fsync) at
             (1,024 x 5) and (4,099 x 16), K = 8, with a barrier before
             each dispatch: the graph superstep on the card, the same K
             steps run eagerly on the card and a CPU engine, every leaf,
             stacked aux key and ENGINE_WAL counter equal after every
             dispatch, elections inside dispatches; byte-equal WAL blocks;
             then each reopens on its own device and the recovered leaves
             are equal
  durable_path
             the durable engine at full width: 10,000 x 5, 128 commands a
             lane a step, wal_shards = min(4, cores / 2), sync_mode 1,
             max_pending 32, through DispatchAheadDriver at K = 8: 2 warm
             and 25 timed dispatches (the tracer on), ms per inner step
             and committed cmds/s beside the volatile superstep_path's,
             fsyncs, records per fsync, fsync p50, WAL MB/s, readback
             bytes against the full batch's, backpressure waits, window
             syncs; a profiler window; commit <= confirm_upto at sampled
             dispatches; after flush_all and settle exact commits,
             counters and WAL counters; a checkpoint, a WAL tail, close
             and open_engine on the card (replay timed), the recovered
             leaves equal those before the close, and a checkpoint-only
             reopen equal on every leaf; the WAL directory under build/
             removed
  durable_diagnosis
             durable_path's timed loop again with fdatasync and without
             (sync_mode 1 and 0), each with the CPU ms of each thread
             group a dispatch, the tracer's spans and a 1 ms sleeper's
             lateness (how long other threads hold the interpreter lock):
             which of the disk and the host sets the pace
  machine_parity
             registers, KV and TTL-KV with reads, FIFO (consumer mix,
             drop_head), a supports_batch_apply=False counter and a
             float-state machine, each on a 64-step seeded schedule
             (failures, recovery, elections inside dispatches) at 512 x
             5: a card engine stepped eagerly against a CPU engine every
             step, and a card engine replaying a K = 8 graph every
             dispatch, every leaf and aux key; the fold kernel launched
             once an eager step and captured K times in the graph
  fifo_path  BASELINE.md's FIFO row: 5,000 x 5, JitFifoMachine(256, 8),
             ring 1,024, 128 commands a lane a step, apply window 130,
             through DispatchAheadDriver at K = 8 (2 warm, 25 timed, 3
             profiled dispatches): (a) bench.py's enqueue 7 /
             dequeue-settled alternation (the reference's fast fold; on
             the card fifo_fold.cu, as every window), (b) a consumer
             mix (the in-order fold in the reference too); ms per inner
             step, committed cmds/s, launches and profiled executions,
             the fold kernel's device ms, idle share, top kernels,
             replica agreement, next_mid = admitted enqueues, and the
             end state equal to a plain model of the queue
  kv_path    the KV row at 10,000 x 5 through the same driver: (a)
             bench.py's put/get mix, (b) the same with every 16th command
             a cas (the in-order fold in the reference too; every mix runs
             slot_fold.cu on the card), (c) TtlKvMachine(64) with
             put/get/delete/watch; the same numbers, end states equal to
             plain models
  stream_path
             StreamMachine() (a ring of 64, 4 groups) at 10,000 x 5
             through the same driver: (a) the firehose, appends only (the
             reference's fast fold; the stream decoder on the card), (b) a
             consumer mix (12 appends, 2 cursor commits near the tail, a
             truncate and an invalid op in every 16) with 16 reads a lane
             riding every dispatch; the same numbers, the end state equal
             to a plain model (StreamModel), every served read equal to
             the model at its watermark, none below the count committed
             before it registered
  wire_path  run_wire_soak at bench.py --wire's defaults: 100,000 loopback
             and 32 socket connections, 1,024 lanes x 3, 12 waves of
             50,000 ops, durable with 2 WAL shards under build/, a
             reconnect storm; the soak's exactly-once oracle, its tail
             row, the device's idle share over the rung's last 3 waves
             (profiled), and the dedup fold's device time at the path's
             window
  tune_path  bench.py's durable rung with RA_TPU_BENCH_AUTOTUNE=1 at
             10,000 x 5 (tune_loop): a TelemetrySampler, Observatory,
             SloEngine (default objectives) and AutoTuner (K from 1 up to
             64, ticks every 0.2 s, the block restaged when K moves) over
             open_engine with durable_path's shards; every decision and
             freeze, each K's committed and sent cmds/s, each capture's ms,
             the last window's phase shares and the verdicts, busy and idle
             from a torch_profile window of 3 dispatches at the converged K;
             held: the knob stamps, the shards' group-commit wait, a freeze
             under a DiskFaultPlan, the committed total against the logs,
             the WAL's accepted rows and the counters, the Prometheus round
             trip
  reads_path bench.py --reads at its defaults (reads_loop): JitKvMachine(64),
             1,024 x 3, durable on 2 WAL shards, K = 4, 8 commands and 16
             reads a lane, read share 0.9, 3 s a section; read and write
             rates and p99s, reads a dispatch, the per-call consistent_read
             baseline, both SLO verdicts; held: no capture over the
             measured sections, every replica's KV state and every served
             read against the lanes' logs rebuilt from the WAL

  mesh_parity
             the counter and JitKvMachine(16) sharded over a 1x4 mesh (3
             members) and a 2x2 mesh (4 members, the members axis split)
             of four slots on cuda:0, and over one slot a card where the
             machine has two cards or more: 1,024 lanes, K = 1 and 8, a
             mid-dispatch election, then mesh_superstep_driver; every
             leaf equal to an unsharded card engine after every dispatch
  mesh_path  the lane mesh at full width on four slots of cuda:0: the
             10,000 x 5 counter at K = 8 x 128 commands through
             mesh_superstep_driver on a 1x4 mesh and 10,000 x 4 on a 2x2
             mesh (ms per inner step, committed cmds/s, each shard's host
             graph call p50, the members axis' gather and scatter ms a
             dispatch) beside superstep_path's unsharded numbers; bench.py
             --multichip's sweep (mesh_shapes(4) x ladder_rungs at 8
             commands, the autotuner walking K, 2 s a point) held against
             a plain model of the mix; open_engine with one WAL shard a
             lane shard under a 1x4 mesh: committed equal to the logs
             rebuilt from the WAL, checkpoint and an equal reopen
  classic_parity
             the classic replicated plane with JitMachines on the card:
             RegisterMachine(8), JitKvMachine(16) and
             JitFifoMachine(capacity=16), each a cluster of three members
             co-hosted on one RaNode over one RaSystem (WAL under build/),
             releasing the log every 500 commands; one seeded script of
             2,000 commands each, pipelined; every reply and every
             member's state equal to the same script run by the port on
             the CPU; stop, recover from disk on the card, every state
             equal again and on the card; the host ms of one
             JitMachine.apply on the card and on the CPU
  classic_path
             bench_classic.py's phase A on the port: one cluster of three
             members co-hosted on one RaNode over one RaSystem (one shared
             durable WAL), 5 clients x 500 in flight, 256-byte payloads,
             bursts of 64, 10 s, the noop counter with a release cursor
             every 100,000 applies: committed cmds/s, applied latency
             p50/p99, fsyncs, records per fsync, the encode share, beside
             the nvidia-smi line and the host CPU; held: every
             acknowledged command applied once on every member and an
             equal state after a reopen.  Then JitKvMachine(64) on the
             card behind the same clients with seeded int32 puts and gets:
             the final state equal to a plain model of the acknowledged
             puts in log order on every member and after a reopen
  tcp_parity three member processes (spawned: CUDA does not survive
             fork), each a RaNode over its own RaSystem behind a
             TcpRouter, their machines' state on the card, against the
             port in one process on the CPU: a seeded JitKvMachine(16)
             script of 2,000 commands pipelined in order, every reply,
             state and applied count equal; a seeded FifoClient script
             (200 enqueues, dequeues and settles), equal, every message
             dequeued once in order; then a list machine's leader process
             killed mid-stream (its launches read just before): 0 acked
             values lost, 0 applied twice
  tcp_path   bench_classic.py's phase B on the port: the three member
             processes (election timeout 800 ms, tick 200 ms), the client
             router here, 5 clients x 500 in flight, 256-byte payloads,
             bursts of 64, 10 s, the noop counter: committed cmds/s,
             applied p50/p99, credit resets, repeated notifications,
             dropped sends, the leader's classic stats over node_call and
             the client's RPC counters; then JitKvMachine(64) applied on
             the card in every member: each member's state equal to a
             plain model of the committed puts in log order; in both
             legs every distinct acked command in the committed log
             once and none twice (every sent command acked once where
             no leader changed); kernel launches counted in the members
             too
  placement_parity
             the failover soak at the reference test's size on the card
             and on the CPU (then on the card with WAL disk faults): 0
             lost acked, 0 double applied, a migration, one down, 8
             sessions re-homed; the adopted engine's recovered state on
             the card equal to open_engine's recovery of the victim's
             directory on the CPU
  placement_path
             two LaneEngineHosts of 1,024 lanes x 3 (2 WAL shards under
             build/, K = 4), 10,000 loopback connections x 2 sessions
             each, 8 waves of 50,000 ops a host, engine A kill-9'd at wave
             3 and adopted by B: the oracle over both engines, recovery
             seconds, counters, client rates around the kill, the idle
             share of the last two waves
  geo_parity the geo soak (run_geo_soak: four OS processes over TCP, the
             far table members behind an 80-150 ms latency-domain matrix,
             a delay-only episode, engine child A SIGKILL'd and adopted by
             B) at the reference's defaults (16 lanes, 24 sessions an
             engine, 5 waves of 300), once with the engine children's
             engines on the card and once on the CPU: rows equal on the
             oracle's counts, ops, sessions, lanes, migrations, downs and
             the domain matrix; each child's commit_phase launches above
             0 on the card and 0 on the CPU
  geo_path   the geo soak on the card at placement_path's host size:
             1,024 lanes and 2,048 sessions an engine, 5 waves of 5,000
             ops: recovery seconds, ops a second, the detector's counts,
             launches in the parent and both children

The fold_kernels phase also holds the stream decoder (random, append-only,
int32-edge and invalid-op windows, a ring of 5 and one of 30,000), and a
FIFO of capacity 12 and a stream of capacity 5 whose batch folds on the
card equal the CPU's at the int32 edge; machine_parity also runs the
stream and the dedup counter.

then the kernels summary line (launches on every path, each counted from
0 just before it: main, superstep, durable, fifo, kv, stream, wire, tune,
reads, mesh_parity, mesh_path, classic_parity, classic_path,
tcp_parity, tcp_path, placement_parity, placement_path, geo_parity and
geo_path, the last two summed over the parent and the engine children;
"launches" is
the count on the kernel's own path), preceded by the script's whole
seconds ("total"), then the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
#: durable phases write their WAL here: a real disk, never tmpfs
WAL_ROOT = Path(__file__).resolve().parent / "build" / "chip_smoke_wal"
NON_TENSOR_OPS_PER_S = 67e12   # H100 SXM fp32 outside the tensor cores


T0 = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:          # seconds since the start, for the budget
        obj = {**obj, "at_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def traced(fn):
    """Run ``fn()`` with a fresh tracer on; returns (fn's result, the
    ``engine.superstep`` spans' host ms a dispatch).  That span is the
    dispatch thread's whole graph call: the copy-in of the state and the
    block, the replay and the clone-out, none of which waits on the
    device."""
    from ra_tpu_torch import trace
    tracer = trace.Tracer()
    trace.set_tracer(tracer)
    try:
        out = fn()
    finally:
        trace.set_tracer(None)
    durs = sorted(e["dur"] / 1e3 for e in tracer.events()
                  if e.get("name") == "engine.superstep")
    return out, {"count": len(durs), "mean_ms": sum(durs) / len(durs),
                 "p50_ms": durs[len(durs) // 2], "max_ms": durs[-1]}


def cuda_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    """Median device time of one call of ``fn``, by CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def graph_ms(fn, reps: int = 200) -> float:
    """Device time of one call of ``fn`` with no host launch cost between
    calls: ``reps`` calls captured in one CUDA graph, replayed, timed by
    CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def quorum_inputs(n: int, p: int, seed: int, device) -> tuple:
    rng = np.random.default_rng(seed)
    commit = rng.integers(0, 50, size=(n,)).astype(np.int32)
    match = rng.integers(0, 100, size=(n, p)).astype(np.int32)
    voter = rng.random((n, p)) < 0.8
    voter[:, 0] = True
    voter[rng.random(n) < 0.05] = False          # lanes with no voters
    tstart = rng.integers(0, 80, size=(n,)).astype(np.int32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (commit, match, voter, tstart))


def bound(n_bytes: int, n_ops: int) -> tuple:
    """(bound_ms, bound_by): the least time for the work on the card."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / NON_TENSOR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def device_sums(prof, kernel: str = "commit_phase_kernel") -> dict:
    """A profiler window's device ms by group (``kernels``, ``copies``,
    ``transfers``: step_profile.device_rows), and the executions and ms
    of the kernels whose name holds ``kernel``; ``rows`` the groups."""
    from ra_tpu_torch.step_profile import device_rows
    rows = device_rows(prof)
    hit = [e for e in rows["kernels"] if kernel in e.key]
    return {**{g: sum(e.self_device_time_total for e in r) / 1e3
               for g, r in rows.items()}, "rows": rows,
            "executions": sum(e.count for e in hit),
            "hit_ms": sum(e.self_device_time_total for e in hit) / 1e3}


def launch_floor_ms(blocks: int, threads: int) -> float:
    """Back to back time of an empty kernel of ``blocks`` x ``threads``
    (``ra_empty_launch``, csrc/quorum.cu) in a CUDA graph, as ``graph_ms``
    times the kernels: the floor under a kernel of that grid."""
    from ra_tpu_torch.ops import _build
    fn = _build.kernel("quorum", "ra_empty_launch",
                       [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

    def launch():
        if fn(blocks, threads, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the empty kernel did not launch")
    return graph_ms(launch)


def kernel_row(name: str, source: str, checks: list, shape: list, call,
               plain, n_bytes: int, n_ops: int, grid: tuple,
               **extra) -> dict:
    """A per-lane kernel timed beside its plain version (a call, and back
    to back in a CUDA graph) and the launch floor at its ``grid``; emits
    the phase's line and returns the kernel's entry."""
    bound_ms, bound_by = bound(n_bytes, n_ops)
    t = {"kernel_ms": cuda_ms(call), "plain_ms": cuda_ms(plain),
         "kernel_graph_ms": graph_ms(call), "plain_graph_ms": graph_ms(plain),
         "launch_floor_graph_ms": launch_floor_ms(*grid)}
    emit({"phase": "kernels", "kernel": name, "checks": checks,
          "shape": shape, **t, "bound_ms": bound_ms, "bytes": n_bytes,
          "ops": n_ops})
    return {"name": name, "route": "cuda", "exact": True,
            "source": f"ra_tpu_torch/ops/csrc/{source}",
            "replaces": "ra_tpu/ops/pallas_quorum.py:47", **extra,
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "shape": shape, "ms": t["kernel_ms"], **t, "bound_ms": bound_ms,
            "bytes": n_bytes, "bound_by": bound_by,
            "library_ms": None}   # no single PyTorch call computes either


def phase_quorum_kernel(pq, quorum, dev) -> dict:
    """The quorum kernel against its plain version, exactly, at ragged
    edges of its 64-lane blocks and P = 1..16; timed at the main path's."""
    checks = []
    for n, p in ((10_000, 5), (513, 2), (1024, 7), (4099, 15), (2048, 16),
                 (63, 5), (64, 5), (65, 5), (10_001, 5), (10_000, 3),
                 (10_000, 9), (1, 1)):
        args = quorum_inputs(n, p, seed=n + p, device=dev)
        got = pq.evaluate_quorum_cuda(*args)
        want = quorum.evaluate_quorum(*args)
        torch.cuda.synchronize()
        exact = bool(torch.equal(got, want)) and got.dtype == want.dtype
        err = int((got.long() - want.long()).abs().max())
        checks.append({"shape": [n, p], "exact": exact, "max_abs_err": err})
        if not exact:
            raise AssertionError(f"quorum kernel != plain version at "
                                 f"{(n, p)}: max |err| {err}")
    n, p = 10_000, 5
    args = quorum_inputs(n, p, seed=1, device=dev)
    return kernel_row(
        "evaluate_quorum", "quorum.cu", checks, [n, p],
        lambda: pq.evaluate_quorum_cuda(*args),
        lambda: quorum.evaluate_quorum(*args),
        n * (4 * p + p + 12),         # each input once, output once
        n * (2 * p * p + 4 * p + 8),  # pairwise count + select + gate
        (-(-n // 64), 64))


def phase_commit_phase_kernel(cpm, dev) -> dict:
    """The fused commit-phase kernel against its plain version: every
    output equal with its dtype, at five shapes, reads on and off; then
    timed at the main path's shape."""
    kr, ttl = 4, 3
    checks = []
    for n, p in ((10_000, 5), (513, 2), (1024, 7), (4099, 15), (2048, 16)):
        args = tuple(torch.from_numpy(x).to(dev)
                     for x in cpm.sample_inputs(n, p, seed=n + p, Kr=kr))
        for supports_read in (True, False):
            kw = dict(lease_ttl=ttl, Kr=kr, supports_read=supports_read)
            want = cpm.commit_phase(*args, **kw)
            got = cpm.commit_phase_cuda(*args, **kw)
            torch.cuda.synchronize()
            bad = [k for k, g, w in zip(cpm.CommitPhase._fields, got, want)
                   if g.dtype != w.dtype or not torch.equal(g, w)]
            err = max(int((g.long() - w.long()).abs().max())
                      for g, w in zip(got, want))
            checks.append({"shape": [n, p], "reads": supports_read,
                           "exact": not bad, "max_abs_err": err})
            if bad:
                raise AssertionError(
                    f"commit-phase kernel != plain version at {(n, p)}, "
                    f"reads {supports_read}: {bad}, max |err| {err}")
    n, p = 10_000, 5
    args = tuple(torch.from_numpy(x).to(dev)
                 for x in cpm.sample_inputs(n, p, seed=1, Kr=kr))
    kw = dict(lease_ttl=ttl, Kr=kr, supports_read=True)
    # each input read once, each output written once: [N,P] 6 int32 and
    # 2 bool in, 4 int32 out; [N] 11 int32 and 3 bool in, 12 int32 and
    # 2 bool out; two P x P selections, the per-member fold and the lane
    # scalars
    return kernel_row(
        "commit_phase", "commit_phase.cu", checks, [n, p],
        lambda: cpm.commit_phase_cuda(*args, **kw),
        lambda: cpm.commit_phase(*args, **kw),
        sum(t.numel() * t.element_size() for t in args) +
        n * (4 * 4 * p + 12 * 4 + 2), n * (2 * 3 * p * p + 20 * p + 40),
        (-(-n // 128), 128), also_replaces="ra_tpu/engine/lockstep.py:450-535")


def assert_same(a, b, aux_a, aux_b, what: str, state_to_numpy) -> None:
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    for k in sb:
        if sa[k].dtype != sb[k].dtype or not np.array_equal(sa[k], sb[k]):
            raise AssertionError(f"cuda != cpu at {what}: {k}")
    for k in (aux_b or {}):
        x, y = aux_a[k].cpu().numpy(), aux_b[k].cpu().numpy()
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"cuda != cpu at {what}: aux {k}")


def phase_parity(pq, cpm, LockstepEngine, CounterMachine, state_to_numpy,
                 dev) -> None:
    N, P, steps = 1024, 5, 64
    kw = dict(write_delay=1, max_step_cmds=16, ring_capacity=19,
              max_step_reads=4, lease_ttl=3, read_timeout=6)
    gpu = LockstepEngine(CounterMachine(), N, P, device=dev, **kw)
    cpu = LockstepEngine(CounterMachine(), N, P, device="cpu", **kw)
    rng = np.random.default_rng(2024)
    K, Kr = gpu.max_step_cmds, gpu.read_window
    failed = {}                  # (lane, slot) -> first step it may heal
    launches = 0
    for i in range(steps):
        leader = cpu.state.leader_slot.numpy()
        for lane, slot in zip(rng.integers(N, size=24),
                              rng.integers(P, size=24)):
            lane, slot = int(lane), int(slot)
            if (lane, slot) not in failed:
                for e in (gpu, cpu):
                    e.fail_member(lane, slot)
                failed[(lane, slot)] = i + int(rng.integers(1, 6))
        heal = [k for k, t in failed.items() if t <= i and
                k[1] != leader[k[0]]]
        if heal:
            lanes, slots = zip(*heal)
            for e in (gpu, cpu):
                e.recover_members(list(lanes), list(slots))
            for k in heal:
                del failed[k]
        if i % 16 == 5:
            lane = int(rng.integers(N))
            slot = (int(leader[lane]) + 1) % P
            if (lane, slot) not in failed:
                for e in (gpu, cpu):
                    e.remove_member(lane, slot)
                    e.add_member(lane, slot, voter=False)
                    e.promote_member(lane, slot)
        n_new = rng.integers(0, K + 1, size=N).astype(np.int32)
        payloads = rng.integers(-9, 10, size=(N, K, 1)).astype(np.int32)
        step_kw = {"elect_mask": rng.random(N) < 0.1,   # ties are common
                   "query_mask": rng.random(N) < 0.2}
        if i % 3 == 0:
            step_kw["n_read"] = np.where(rng.random(N) < 0.5,
                                         rng.integers(1, Kr + 2, size=N),
                                         0).astype(np.int32)
            step_kw["read_q"] = np.zeros((N, Kr, 1), np.int32)
        before = cpm.LAUNCHES, pq.LAUNCHES
        aux_g = gpu.step(n_new, payloads, **step_kw)
        if (cpm.LAUNCHES, pq.LAUNCHES) != (before[0] + 1, before[1]):
            raise AssertionError("a cuda step must launch the commit-phase "
                                 "kernel exactly once and no other")
        launches += 1
        aux_c = cpu.step(n_new, payloads, **step_kw)
        assert_same(gpu, cpu, aux_g, aux_c, f"step {i}", state_to_numpy)
        if i % 8 == 7:
            lanes = rng.choice(N, size=32, replace=False)
            for e in (gpu, cpu):
                e.trigger_election(lanes)
            launches += 1
            assert_same(gpu, cpu, None, None, f"election after {i}",
                        state_to_numpy)
    st = cpu.state
    if int(st.telem.leader_changes.sum()) == 0 or \
            int(st.read_served.sum()) == 0:
        raise AssertionError("the parity schedule moved no leader or "
                             "served no read")
    emit({"phase": "parity", "lanes": N, "members": P,
          "steps": steps + steps // 8, "equal_every_step": True,
          "kernel_launches": launches,
          "elections_won": int(st.telem.elections_won.sum()),
          "leader_changes": int(st.telem.leader_changes.sum()),
          "committed": cpu.committed_total(),
          "reads_served": int(st.read_served.sum()),
          "reads_refused": int(st.read_stale.sum() + st.read_shed.sum())})


def phase_main_path(pq, cpm, LockstepEngine, CounterMachine, dev,
                    n_lanes: int = 10_000) -> dict:
    N, P, cmds = n_lanes, 5, 128
    warm, timed = 10, 200
    mods = kernel_modules(zero=True)
    eng = LockstepEngine(CounterMachine(), N, P, ring_capacity=1024,
                         max_step_cmds=128, apply_window=130, write_delay=1,
                         device=dev)
    for _ in range(warm):
        eng.uniform_step(cmds)
    torch.cuda.synchronize()
    committed0 = eng.committed_total()
    t0 = time.perf_counter()
    for _ in range(timed):
        eng.uniform_step(cmds)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    committed1 = eng.committed_total()
    for _ in range(2):           # settle the last confirms
        eng.uniform_step(0)
    want = cmds * (warm + timed)
    per_lane = eng.committed_per_lane()
    counters = eng.machine_states()                       # [N, P]
    lead = eng.state.leader_slot.cpu().numpy()
    lead_value = counters[np.arange(N), lead]
    if not (per_lane == want).all():
        raise AssertionError(f"total_committed != {want} on "
                             f"{int((per_lane != want).sum())} lanes")
    if not (lead_value == want).all():
        raise AssertionError(f"leader counter != {want} on "
                             f"{int((lead_value != want).sum())} lanes")
    lanes = np.linspace(0, N - 1, 64).astype(np.int64)
    replies, wm, ok = eng.read_lanes(lanes, np.zeros((64, 1), np.int32))
    if not ok.all() or not (replies[:, 0] == lead_value[lanes]).all():
        raise AssertionError("read_lanes did not serve the counters")
    torch.cuda.synchronize()
    launches = {name: m.LAUNCHES for name, m in mods.items()}
    steps = eng.pipeline_counters["inner_steps"]
    if launches != {"commit_phase": steps, "evaluate_quorum": 0,
                    "slot_fold": 0, "fifo_fold": 0}:
        raise AssertionError(f"kernel launches {launches} in {steps} "
                             "main-path steps; want one commit_phase a "
                             "step and no other kernel")
    emit({"phase": "main_path", "lanes": N, "members": P,
          "cmds_per_step": cmds, "timed_steps": timed,
          "committed_cmds_per_s": (committed1 - committed0) / seconds,
          "ms_per_step": seconds / timed * 1e3,
          "committed_per_lane": want, "leader_counter_ok": True,
          "read_lanes_ok": True, "read_watermark_min": int(wm.min()),
          "engine_steps": steps, "kernel_launches": launches,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    return launches


#: superstep's schedule keywords by step()'s names for them
STEP_KW = {"elect_blk": "elect_mask", "query_blk": "query_mask",
           "n_read_blk": "n_read", "read_q_blk": "read_q"}


def stacked_steps(eng, n_new, pay, **kw) -> dict:
    """K eager ``step()`` calls, the aux stacked as superstep stacks it;
    ``kw`` holds superstep's schedule keywords."""
    from ra_tpu_torch.engine.lockstep import step_watermarks
    auxes = []
    for j in range(n_new.shape[0]):
        aux = eng.step(n_new[j], pay[j],
                       **{STEP_KW[k]: v[j] for k, v in kw.items()})
        auxes.append({**aux, **step_watermarks(eng.state)})
    return {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}


def host_aux(aux: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in aux.items()}


def assert_arrays(got: dict, want: dict, what: str) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys {sorted(got)} != {sorted(want)}")
    for k in want:
        if got[k].dtype != want[k].dtype or \
                not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs")


def churn(engines, leader, failed: list, rng, N: int, P: int,
          size: int = 64) -> tuple:
    """Recover the members of ``failed`` that do not lead now, then fail
    the leader of ``size / 2`` lanes drawn from ``rng`` and a follower of
    as many more, on every engine; returns (those lanes, the failed)."""
    heal = [(lane, slot) for lane, slot in failed if slot != leader[lane]]
    lanes = rng.choice(N, size=size, replace=False)
    failed = [(int(n), int(leader[n])) for n in lanes[:size // 2]] + \
        [(int(n), (int(leader[n]) + 1) % P) for n in lanes[size // 2:]]
    for e in engines:
        if heal:
            e.recover_members([n for n, _ in heal], [s for _, s in heal])
        for lane, slot in failed:
            e.fail_member(lane, slot)
    return lanes, failed


def phase_superstep_parity(cpm, LockstepEngine, CounterMachine,
                           state_to_numpy, devicewatch, dev) -> None:
    K = 8
    kw = dict(write_delay=1, max_step_cmds=8, ring_capacity=16,
              apply_window=4, max_step_reads=4, lease_ttl=3,
              read_timeout=6)
    for N, P in ((1024, 5), (4099, 16)):
        graph = LockstepEngine(CounterMachine(), N, P, device=dev, **kw)
        eager = LockstepEngine(CounterMachine(), N, P, device=dev, **kw)
        cpu = LockstepEngine(CounterMachine(), N, P, device="cpu", **kw)
        engines = (graph, eager, cpu)
        rng = np.random.default_rng(N + P)
        captures0 = devicewatch.WATCH.counters["compiles"]
        failed, held, clipped = [], None, 0
        dispatches = 5
        for d in range(dispatches):
            lanes, failed = churn(engines, cpu.state.leader_slot.numpy(),
                                  failed, rng, N, P)
            n_new = rng.integers(0, 9, (K, N)).astype(np.int32)
            n_new[:, rng.random(N) < 0.3] = 8        # fill the ring
            pay = rng.integers(-9, 10, (K, N, 8, 1)).astype(np.int32)
            elect = np.zeros((K, N), bool)
            elect[3, lanes[:32]] = True
            elect[6] = rng.random(N) < 0.05
            sched = {"elect_blk": elect,
                     "query_blk": rng.random((K, N)) < 0.2}
            if d == 2:
                nr, rq = graph.uniform_read_block(K, 3)
                sched.update(n_read_blk=nr, read_q_blk=rq)
            aux_g = graph.superstep(n_new, pay, **sched)
            aux_e = stacked_steps(eager, n_new, pay, **sched)
            aux_c = cpu.superstep(n_new, pay, **sched)
            torch.cuda.synchronize()
            want = host_aux(aux_c)
            what = f"superstep ({N}, {P}) dispatch {d}"
            assert_arrays(host_aux(aux_g), want, what + " graph aux")
            assert_arrays(host_aux(aux_e), want, what + " eager aux")
            sc = state_to_numpy(cpu.state)
            assert_arrays(state_to_numpy(graph.state), sc,
                          what + " graph state")
            assert_arrays(state_to_numpy(eager.state), sc,
                          what + " eager state")
            if held is not None:
                # what dispatch d-1 returned is unchanged by dispatch d
                assert_arrays(host_aux(held[0]), held[1], what + " held aux")
                assert_arrays(state_to_numpy(held[2]), held[3],
                              what + " held state")
            held = (aux_g, host_aux(aux_g), graph.state,
                    state_to_numpy(graph.state))
            clipped += int((want["n_acc"] < n_new).sum())
        st = cpu.state
        graphs = list(graph._graphs._graphs.values())
        captured = [g.captured_launches["commit_phase"] for g in graphs]
        if captured != [K, K] or \
                devicewatch.WATCH.counters["compiles"] - captures0 \
                != 2:
            raise AssertionError(f"want two graphs (without and with reads) "
                                 f"of {K} captured commit_phase launches "
                                 f"each, got {captured}")
        if int(st.telem.leader_changes.sum()) == 0 or clipped == 0 or \
                int(st.read_served.sum()) == 0:
            raise AssertionError("the superstep schedule moved no leader, "
                                 "hit no backpressure or served no read")
        emit({"phase": "superstep_parity", "lanes": N, "members": P,
              "superstep_k": K, "dispatches": dispatches,
              "equal_every_dispatch": True, "held_unchanged": True,
              "graphs": len(graphs), "captured_launches": captured,
              "graph_held_mb": [g.held_bytes / 2**20 for g in graphs],
              "leader_changes": int(st.telem.leader_changes.sum()),
              "backpressure_clipped": clipped,
              "reads_served": int(st.read_served.sum()),
              "committed": cpu.committed_total()})


def ledger(devicewatch) -> dict:
    return {site: dict(v) for site, v in devicewatch.WATCH.sites.items()}


def counter_blocks(N: int, cmds: int, K: int) -> tuple:
    """(n_blk, p_blk) of a counter dispatch: ``cmds`` increments of 1 a
    lane in each of K inner steps."""
    return (np.broadcast_to(np.full(N, cmds, np.int32), (K, N)),
            np.broadcast_to(np.ones((N, cmds, 1), np.int32),
                            (K, N, cmds, 1)))


def phase_superstep_path(pq, cpm, LockstepEngine, CounterMachine,
                         DispatchAheadDriver, TelemetrySampler, devicewatch,
                         dev, n_lanes: int = 10_000) -> dict:
    N, P, cmds, K = n_lanes, 5, 128, 8
    warm, timed, profiled = 2, 25, 3
    mods = kernel_modules(zero=True)
    torch.cuda.reset_peak_memory_stats()
    eng = LockstepEngine(CounterMachine(), N, P, ring_capacity=1024,
                         max_step_cmds=cmds, apply_window=130, write_delay=1,
                         device=dev)
    sampler = TelemetrySampler(eng)
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    # the bench's staged blocks: host numpy, 41 MB of payload a block
    n_blk, p_blk = counter_blocks(N, cmds, K)
    for _ in range(warm):
        drv.submit(n_blk, p_blk)
    drv.drain()
    # the sampler's first sample allocates its pinned host buffers: take
    # it before the timed window
    sampler.drain()
    eng.phases.reset_reservoirs()
    torch.cuda.synchronize()
    watch0, sites0 = dict(devicewatch.WATCH.counters), ledger(devicewatch)
    pc0 = dict(eng.pipeline_counters)
    committed0, wait0 = eng.committed_total(), drv.window_wait_s

    def timed_window():
        t0 = time.perf_counter()
        for _ in range(timed):
            drv.submit(n_blk, p_blk)
        drv.drain()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    seconds, graph_call = traced(timed_window)
    window_wait_ms = (drv.window_wait_s - wait0) / timed * 1e3
    phases = eng.phases.overview()
    committed1 = eng.committed_total()
    watch1, sites1 = dict(devicewatch.WATCH.counters), ledger(devicewatch)
    pc = {k: eng.pipeline_counters[k] - pc0[k] for k in pc0}
    captures = watch1["compiles"] - watch0["compiles"]
    recaptures = watch1["recompiles"] - watch0["recompiles"]
    if captures or recaptures or pc["superstep_dispatches"] != timed:
        raise AssertionError(f"timed window: {captures} graph captures, "
                             f"{recaptures} re-captures, "
                             f"{pc['superstep_dispatches']} dispatches")
    per_dispatch = {
        site: {k: (v - sites0.get(site, {}).get(k, 0)) / timed
               for k, v in s.items()}
        for site, s in sites1.items()}
    # K = 1 through the same driver: one graph replay a step (timed
    # before the profiler runs in this process)
    n1, p1 = n_blk[:1], p_blk[:1]
    for _ in range(warm):
        drv.submit(n1, p1)
    drv.drain()
    torch.cuda.synchronize()
    c0, steps1 = eng.committed_total(), 100
    syncs0 = eng.pipeline_counters["window_syncs"]
    t0 = time.perf_counter()
    for _ in range(steps1):
        drv.submit(n1, p1)
    drv.drain()
    torch.cuda.synchronize()
    s1 = time.perf_counter() - t0
    k1 = {"phase": "superstep_path_k1", "lanes": N, "members": P,
          "superstep_k": 1, "timed_dispatches": steps1,
          "ms_per_inner_step": s1 / steps1 * 1e3,
          "committed_cmds_per_s": (eng.committed_total() - c0) / s1,
          "window_syncs": eng.pipeline_counters["window_syncs"] - syncs0}
    # a profiler window: commit_phase executions on the device, by name
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(profiled):
            drv.submit(n_blk, p_blk)
        drv.drain()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t1
    sums = device_sums(prof)
    rows, executions = sums["rows"]["kernels"], sums["executions"]
    # the dispatch stream's busy time (kernels and device-to-device
    # copies); the block's host-to-device copy overlaps it on a copy
    # engine and is reported apart
    kernel_ms, transfer_ms = sums["kernels"], sums["transfers"]
    busy_ms = kernel_ms + sums["copies"]
    if executions != profiled * K:
        raise AssertionError(f"{executions} commit_phase executions in a "
                             f"profiler window of {profiled * K} inner "
                             "steps")
    graph = eng._graphs._graphs[(K, cmds, False, False)]
    launches = {name: m.LAUNCHES for name, m in mods.items()}
    # host launches: for each of the two graphs (K and 1) the warm-up
    # before its capture, and the capture
    if graph.captured_launches["commit_phase"] != K or \
            launches != {"commit_phase": 2 * (K + 1), "evaluate_quorum": 0,
                         "slot_fold": 0, "fifo_fold": 0}:
        raise AssertionError(f"superstep path launches {launches}, "
                             f"captured {graph.captured_launches}; want "
                             f"{K + 1} warm-up and {K + 1} captured "
                             "commit_phase launches and no other kernel")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    # settle the last confirms with an empty block, then check
    drv.submit(np.zeros((K, N), np.int32), p_blk)
    drv.drain()
    want = cmds * (K * (warm + timed + profiled) + warm + steps1)
    per_lane = eng.committed_per_lane()
    counters = eng.machine_states()
    lead = eng.state.leader_slot.cpu().numpy()
    lead_value = counters[np.arange(N), lead]
    if not (per_lane == want).all() or not (lead_value == want).all():
        raise AssertionError(
            f"superstep path: total_committed != {want} on "
            f"{int((per_lane != want).sum())} lanes, leader counter on "
            f"{int((lead_value != want).sum())}")
    if not (drv.last_committed == per_lane).all():
        raise AssertionError("drain() watermark != total_committed")
    snap = sampler.drain()
    if snap["committed_total"] != eng.committed_total() or \
            snap["stalled_lanes"] != 0:
        raise AssertionError(f"sampler: committed_total "
                             f"{snap['committed_total']} (host "
                             f"{eng.committed_total()}), stalled_lanes "
                             f"{snap['stalled_lanes']}")
    lanes = np.linspace(0, N - 1, 64).astype(np.int64)
    replies, wm, ok = eng.read_lanes(lanes, np.zeros((64, 1), np.int32))
    if not ok.all() or not (replies[:, 0] == lead_value[lanes]).all():
        raise AssertionError("read_lanes did not serve the counters")
    drv.close()
    volatile = {"ms_per_inner_step": seconds / (timed * K) * 1e3,
                "committed_cmds_per_s": (committed1 - committed0) / seconds}
    emit({"phase": "superstep_path", "lanes": N, "members": P,
          "superstep_k": K, "cmds_per_step": cmds, "timed_dispatches": timed,
          "ms_per_inner_step": seconds / (timed * K) * 1e3,
          "committed_cmds_per_s": (committed1 - committed0) / seconds,
          "window_syncs": pc["window_syncs"],
          "window_wait_ms_per_dispatch": window_wait_ms,
          "host_graph_call_ms": graph_call,
          "dispatches": pc["superstep_dispatches"],
          "graph_captures_timed": captures, "graph_recaptures": recaptures,
          "capture_ms": graph.capture_ms,
          "graph_held_mb": graph.held_bytes / 2**20,
          "peak_mem_mb": peak_mb,
          "ledger_per_dispatch": per_dispatch,
          "profiled_inner_steps": profiled * K,
          "commit_phase_executions": executions,
          "traced_ms_per_inner_step": traced_s / (profiled * K) * 1e3,
          "device_busy_ms_per_inner_step": busy_ms / (profiled * K),
          "kernel_ms_per_inner_step": kernel_ms / (profiled * K),
          "transfer_ms_per_inner_step": transfer_ms / (profiled * K),
          "device_idle_share_traced": 1.0 - busy_ms / (traced_s * 1e3),
          # the same busy time against the untraced window's inner step
          "device_idle_share_untraced": 1.0 - busy_ms / (profiled * K) /
          (seconds / (timed * K) * 1e3),
          "host_launches": launches,
          "committed_per_lane": want, "leader_counter_ok": True,
          "read_lanes_ok": True, "sampler_committed_total":
          snap["committed_total"], "sampler_stalled_lanes": 0,
          "phases_ms": {p: {q: phases[p][q] for q in ("p50_ms", "p99_ms",
                                                      "max_ms")}
                        for p in ("host_staging", "device_dispatch")}})
    emit(k1)
    return volatile, {name: {"host_launches": launches[name],
                   "captured_per_graph": graph.captured_launches[name],
                   "profiled_executions": sum(
                       e.count for e in rows if f"{name}_kernel" in e.key),
                   "profiled_inner_steps": profiled * K}
            for name in launches}


# -- the durable engine ------------------------------------------------------

#: the leaves a recovery replays to (everything but the per-step clocks
#: and telemetry, which count the replay's own steps)
CORE_LEAVES = ("term", "leader_slot", "term_start", "last_index",
               "last_written", "commit", "applied", "total_committed",
               "voter", "active", "mac")


def wal_blocks(data_dir: str, scan_wal_file) -> dict:
    """Every engine block on disk: {(shard dir, step): block bytes}."""
    out = {}
    for root, _dirs, names in os.walk(data_dir):
        tables: dict = {}
        for name in sorted(n for n in names if n.endswith(".wal")):
            scan_wal_file(os.path.join(root, name), tables)
        for step, (_term, blk) in tables.get("__engine__", {}).items():
            out[(os.path.relpath(root, data_dir), step)] = blk
    return out


def core(state, state_to_numpy) -> dict:
    return {k: v for k, v in state_to_numpy(state).items()
            if k.split(":")[0] in CORE_LEAVES}


def phase_wal_disk() -> dict:
    from ra_tpu_torch.wal_probe import probe
    out = probe(str(WAL_ROOT / "probe"),
                max(1, min(4, (os.cpu_count() or 2) // 2)))
    emit({"phase": "wal_disk", **out})
    return out


def phase_durable_parity(cpm, CounterMachine, open_engine, state_to_numpy,
                         scan_wal_file, dev) -> None:
    K = 8
    kw = dict(max_step_cmds=8, ring_capacity=16, apply_window=4,
              max_step_reads=4, lease_ttl=3, read_timeout=6, sync_mode=1,
              max_pending=64, wal_shards=2)
    for N, P in ((1024, 5), (4099, 16)):
        root = WAL_ROOT / f"parity_{N}_{P}"
        shutil.rmtree(root, ignore_errors=True)
        names = ("graph", "eager", "cpu")
        devs = (dev, dev, "cpu")

        def open_all():
            return [open_engine(CounterMachine(), str(root / name), N, P,
                                device=d, **kw)
                    for name, d in zip(names, devs)]
        engines = open_all()
        engines[1]._graphs = None         # _superstep's eager K-step loop
        cpu = engines[2]
        rng = np.random.default_rng(N + P + 1)
        failed, launches0 = [], cpm.LAUNCHES
        for d in range(5):
            lanes, failed = churn(engines, cpu.state.leader_slot.numpy(),
                                  failed, rng, N, P)
            n_new = rng.integers(0, 9, (K, N)).astype(np.int32)
            n_new[:, rng.random(N) < 0.3] = 8
            pay = rng.integers(-9, 10, (K, N, 8, 1)).astype(np.int32)
            elect = np.zeros((K, N), bool)
            elect[3, lanes[:32]] = True
            elect[6] = rng.random(N) < 0.05
            for e in engines:                   # the same confirms
                e._dur.flush_all()
            auxes = [e.superstep(n_new, pay, elect_blk=elect)
                     for e in engines]
            torch.cuda.synchronize()
            for e in engines:
                e._dur.flush_all()
            want = state_to_numpy(cpu.state)
            want_aux = host_aux(auxes[2])
            for e, aux, name in zip(engines, auxes, names):
                what = f"durable ({N}, {P}) dispatch {d} {name}"
                assert_arrays(state_to_numpy(e.state), want, what)
                assert_arrays(host_aux(aux), want_aux, what + " aux")
                if e._dur.counters != cpu._dur.counters:
                    raise AssertionError(f"{what}: WAL counters "
                                         f"{e._dur.counters} != "
                                         f"{cpu._dur.counters}")
        eager_launches = cpm.LAUNCHES - launches0
        st = cpu.state
        committed = cpu.committed_total()
        counters = dict(cpu._dur.counters)
        for e in engines:
            e.close()
        blocks = [wal_blocks(str(root / name), scan_wal_file)
                  for name in names]
        if not blocks[2] or any(b != blocks[2] for b in blocks[:2]):
            raise AssertionError(f"durable ({N}, {P}): WAL blocks differ")
        t0 = time.perf_counter()
        engines = open_all()
        reopen_s = time.perf_counter() - t0
        want = state_to_numpy(engines[2].state)
        for e, name in zip(engines, names):
            assert_arrays(state_to_numpy(e.state), want,
                          f"durable ({N}, {P}) reopened {name}")
        for e in engines:
            e.close()
        shutil.rmtree(root, ignore_errors=True)
        if int(st.telem.leader_changes.sum()) == 0 or committed == 0:
            raise AssertionError("the durable schedule moved no leader or "
                                 "committed nothing")
        emit({"phase": "durable_parity", "lanes": N, "members": P,
              "superstep_k": K, "dispatches": 5, "wal_shards": 2,
              "equal_every_dispatch": True, "wal_blocks_equal": True,
              "wal_blocks": len(blocks[2]), "recovered_equal": True,
              "reopen_s_three_engines": reopen_s,
              "eager_commit_phase_launches": eager_launches,
              "leader_changes": int(st.telem.leader_changes.sum()),
              "committed": committed, "wal_counters": counters})


def wal_totals(eng) -> dict:
    ov = eng._dur.wal_overview()
    out = {k: sum(s[k] for s in ov["shards"])
           for k in ("syncs", "writes", "bytes_written", "sync_time_us",
                     "batches")}
    out.update(ov["engine"])
    out["fsync_p50_ms"] = statistics.median(s["fsync_p50_ms"]
                                            for s in ov["shards"])
    out["fsync_p99_ms"] = max(s["fsync_p99_ms"] for s in ov["shards"])
    return out


def settle_durable(eng, cmds: int, limit: int = 64) -> int:
    """Empty single steps behind a durability barrier until every lane's
    leader has committed and applied its whole log; returns the steps."""
    N = eng.n_lanes
    zn, zp = np.zeros(N, np.int32), np.zeros((N, cmds, 1), np.int32)
    lane = np.arange(N)
    for i in range(limit):
        eng._dur.flush_all()
        st = eng.state
        lead = st.leader_slot.cpu().numpy()
        tail = st.last_index.cpu().numpy()[lane, lead]
        com = st.commit.cpu().numpy()[lane, lead]
        app = st.applied.cpu().numpy().min(axis=1)
        if (com == tail).all() and (app == tail).all() and i:
            return i
        eng.step(zn, zp)
    raise AssertionError("the durable engine did not settle")


def phase_durable_path(pq, cpm, CounterMachine, DispatchAheadDriver,
                       open_engine, trace, state_to_numpy, dev,
                       volatile: dict, n_lanes: int = 10_000) -> dict:
    from ra_tpu_torch.engine.durable import _BLK, _BLK2
    from ra_tpu_torch.log import faults
    from ra_tpu_torch.wal_probe import fs_info
    N, P, cmds, K = n_lanes, 5, 128, 8
    warm, timed, profiled, sampled, tail = 2, 25, 3, 4, 3
    shards = max(1, min(4, (os.cpu_count() or 2) // 2))
    root = WAL_ROOT / "path"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    fs = fs_info(str(root))
    kw = dict(wal_shards=shards, sync_mode=1, max_pending=32,
              ring_capacity=1024, max_step_cmds=cmds, apply_window=130)
    mods = kernel_modules(zero=True)
    torch.cuda.reset_peak_memory_stats()
    eng = open_engine(CounterMachine(), str(root), N, P, device=dev, **kw)
    io_native = faults.IO._base.native      # native library or fallback
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    n_blk, p_blk = counter_blocks(N, cmds, K)
    for _ in range(warm):
        drv.submit(n_blk, p_blk)
    drv.drain()
    eng._dur.flush_all()
    torch.cuda.synchronize()
    w0, pc0 = wal_totals(eng), dict(eng.pipeline_counters)
    committed0, wait0 = eng.committed_total(), drv.window_wait_s
    tracer = trace.Tracer()
    trace.set_tracer(tracer)
    t0 = time.perf_counter()
    try:
        for _ in range(timed):
            drv.submit(n_blk, p_blk)
        drv.drain()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        trace.set_tracer(None)
    committed1 = eng.committed_total()
    w1 = wal_totals(eng)
    pc = {k: eng.pipeline_counters[k] - pc0[k] for k in pc0}
    spans = tracer.summary()
    bp = [e["dur"] for e in tracer.events()
          if e.get("name") == "engine.backpressure"]
    dw = {k: w1[k] - w0[k] for k in ("syncs", "writes", "bytes_written",
                                    "sync_time_us", "readback_bytes",
                                    "readback_bytes_full")}
    # a profiler window: device busy and the commit-phase executions
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(profiled):
            drv.submit(n_blk, p_blk)
        drv.drain()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t1
    sums = device_sums(prof)
    executions, kernel_ms = sums["executions"], sums["kernels"]
    copy_ms, transfer_ms = sums["copies"], sums["transfers"]
    if executions != profiled * K:
        raise AssertionError(f"{executions} commit_phase executions in a "
                             f"durable profiler window of {profiled * K} "
                             "inner steps")
    # sampled dispatches: no lane commits past the WAL's fsync horizon
    # (monotone without elections, so the horizon read after the
    # dispatch bounds the one the dispatch used)
    drv.close()
    lane = np.arange(N)
    for _ in range(sampled):
        eng.superstep(n_blk, p_blk)
        torch.cuda.synchronize()
        confirm = eng._dur.confirm_upto.copy()
        st = eng.state
        com = st.commit.cpu().numpy()[lane, st.leader_slot.cpu().numpy()]
        if not (com <= confirm).all():
            raise AssertionError("a lane committed past confirm_upto")
    settle_steps = settle_durable(eng, cmds)
    # exact: every accepted command committed once and applied by every
    # member; the WAL counters follow from the step and row counts
    steps = eng._dur.step_seq
    per_lane = eng.committed_per_lane().astype(np.int64)
    st = eng.state
    lead = st.leader_slot.cpu().numpy()
    counter = eng.machine_states()
    if not (counter[lane, lead] == per_lane).all() or \
            not (counter == per_lane[:, None]).all():
        raise AssertionError("durable path: counters != committed")
    rows = int(per_lane.sum())
    ctr = eng._dur.counters
    want_ctr = {
        "encoded_blocks": shards * steps,
        "readback_bytes": steps * (16 * N + 4 * (shards - 1)) + 4 * rows,
        "readback_bytes_full": steps * (12 * N + 4 * N * cmds),
        "encoded_bytes": steps * (_BLK.size + _BLK2.size * (shards - 1)
                                  + 12 * N) + 4 * rows}
    if ctr != want_ctr:
        raise AssertionError(f"durable WAL counters {ctr} != {want_ctr}")
    if not (eng.state.total_committed.cpu().numpy() ==
            eng.state.last_index.cpu().numpy()[lane, lead]).all():
        raise AssertionError("durable path: a committed tail != the log")
    # recovery: a checkpoint, a WAL tail after it, close, replay
    t0 = time.perf_counter()
    eng.checkpoint()
    ckpt_s = time.perf_counter() - t0
    step0 = eng._dur.step_seq
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    for _ in range(tail):
        drv.submit(n_blk, p_blk)
    drv.close()
    settle_durable(eng, cmds)
    replay_steps = eng._dur.step_seq - step0
    before = core(eng.state, state_to_numpy)
    committed_before = eng.committed_total()
    eng.close()
    launches0 = cpm.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = open_engine(CounterMachine(), str(root), N, P, device=dev, **kw)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    replay_launches = cpm.LAUNCHES - launches0
    assert_arrays(core(eng.state, state_to_numpy), before,
                  "durable path recovered")
    if replay_launches < replay_steps:
        raise AssertionError(f"recovery replayed {replay_steps} steps with "
                             f"{replay_launches} commit_phase launches")
    eng.checkpoint()
    full = state_to_numpy(eng.state)
    eng.close()
    t0 = time.perf_counter()
    eng = open_engine(CounterMachine(), str(root), N, P, device=dev, **kw)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert_arrays(state_to_numpy(eng.state), full,
                  "durable path checkpoint reopen")
    eng.close()
    shutil.rmtree(root, ignore_errors=True)
    launches = used_only("durable path", mods, "commit_phase")
    inner = timed * K
    ms = seconds / inner * 1e3
    emit({"phase": "durable_path", "lanes": N, "members": P,
          "superstep_k": K, "cmds_per_step": cmds, "timed_dispatches": timed,
          "wal_shards": shards, "sync_mode": 1, "max_pending": 32,
          "filesystem": fs, "native_io": io_native,
          "ms_per_inner_step": ms,
          "committed_cmds_per_s": (committed1 - committed0) / seconds,
          "volatile_ms_per_inner_step": volatile["ms_per_inner_step"],
          "volatile_committed_cmds_per_s":
          volatile["committed_cmds_per_s"],
          "fsyncs": dw["syncs"], "wal_records": dw["writes"],
          "records_per_fsync": dw["writes"] / max(1, dw["syncs"]),
          "fsync_p50_ms": w1["fsync_p50_ms"],
          "fsync_p99_ms": w1["fsync_p99_ms"],
          "fsync_busy_share": dw["sync_time_us"] / 1e6 / seconds / shards,
          "wal_mb_per_s": dw["bytes_written"] / seconds / 1e6,
          "readback_bytes": dw["readback_bytes"],
          "readback_bytes_full": dw["readback_bytes_full"],
          "backpressure_waits": sum(1 for d in bp if d > 100.0),
          "backpressure_ms_per_dispatch": sum(bp) / 1e3 / timed,
          "window_syncs": pc["window_syncs"],
          "window_wait_ms_per_dispatch":
          (drv.window_wait_s - wait0) / timed * 1e3,
          "spans_ms_per_dispatch": {
              k: v["total_us"] / 1e3 / timed for k, v in spans.items()
              if k != "_meta"},
          "spans_max_ms": {k: v["max_us"] / 1e3 for k, v in spans.items()
                           if k != "_meta"},
          "spans_count": {k: v["count"] for k, v in spans.items()
                          if k != "_meta"},
          "traced_ms_per_inner_step": traced_s / (profiled * K) * 1e3,
          "kernel_ms_per_inner_step": kernel_ms / (profiled * K),
          "d2d_copy_ms_per_inner_step": copy_ms / (profiled * K),
          "transfer_ms_per_inner_step": transfer_ms / (profiled * K),
          "device_idle_share_traced":
          1.0 - (kernel_ms + copy_ms) / (traced_s * 1e3),
          "commit_phase_executions": executions,
          "sampled_dispatches_commit_le_confirm": sampled,
          "settle_steps": settle_steps, "wal_counters_exact": True,
          "checkpoint_s": ckpt_s, "replayed_steps": replay_steps,
          "recovery_s": recovery_s,
          "replay_steps_per_s": replay_steps / recovery_s,
          "checkpoint_reopen_s": restore_s,
          "committed_before_close": committed_before,
          "recovered_equal": True,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
          "host_launches": launches})
    return launches


def thread_cpu_s() -> dict:
    """CPU seconds of this process's live threads, summed by name with
    the digits dropped (a plane's shard threads are one group)."""
    out: dict = {}
    for t in threading.enumerate():
        try:
            s = time.clock_gettime(time.pthread_getcpuclockid(t.ident))
        except (OSError, TypeError):        # the thread has just ended
            continue
        name = re.sub(r"\d+", "", t.name)
        out[name] = out.get(name, 0.0) + s
    return out


class LockProbe(threading.Thread):
    """Sleeps 1 ms at a time and keeps how late each wake-up comes back:
    a woken thread must take the interpreter lock again, so the lateness
    is how long other threads hold it."""

    def __init__(self) -> None:
        super().__init__(daemon=True, name="lock-probe")
        self.late_ms: list = []
        self._stop_ev = threading.Event()

    def run(self) -> None:
        while not self._stop_ev.is_set():
            t = time.perf_counter()
            time.sleep(0.001)
            self.late_ms.append((time.perf_counter() - t) * 1e3 - 1.0)

    def stop(self) -> dict:
        self._stop_ev.set()
        self.join()
        late = sorted(self.late_ms)
        return {"wakeups": len(late),
                "late_ms_p50": late[len(late) // 2],
                "late_ms_p90": late[int(len(late) * 0.9)],
                "late_ms_mean": statistics.fmean(late)}


def phase_durable_diagnosis(CounterMachine, DispatchAheadDriver,
                            open_engine, trace, dev,
                            n_lanes: int = 10_000) -> None:
    """``durable_path``'s timed loop twice, with fdatasync (sync_mode 1)
    and without (0): which of the disk and the host sets ms per inner
    step and committed cmds/s.  Each run reports the CPU seconds of each
    thread group, the dispatch thread's spans and how late a 1 ms sleeper
    gets the interpreter lock back."""
    N, P, cmds, K = n_lanes, 5, 128, 8
    warm, timed = 2, 25
    shards = max(1, min(4, (os.cpu_count() or 2) // 2))
    n_blk, p_blk = counter_blocks(N, cmds, K)
    runs = {}
    for sync_mode in (1, 0):
        root = WAL_ROOT / f"diagnosis{sync_mode}"
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        eng = open_engine(CounterMachine(), str(root), N, P, device=dev,
                          wal_shards=shards, sync_mode=sync_mode,
                          max_pending=32, ring_capacity=1024,
                          max_step_cmds=cmds, apply_window=130)
        drv = DispatchAheadDriver(eng, max_in_flight=2)
        for _ in range(warm):
            drv.submit(n_blk, p_blk)
        drv.drain()
        eng._dur.flush_all()
        torch.cuda.synchronize()
        w0, committed0 = wal_totals(eng), eng.committed_total()
        tracer = trace.Tracer()
        trace.set_tracer(tracer)
        probe = LockProbe()
        cpu0, proc0 = thread_cpu_s(), time.process_time()
        probe.start()
        t0 = time.perf_counter()
        try:
            for _ in range(timed):
                drv.submit(n_blk, p_blk)
            drv.drain()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            trace.set_tracer(None)
            lock = probe.stop()
        cpu1, proc1 = thread_cpu_s(), time.process_time()
        committed1, w1 = eng.committed_total(), wal_totals(eng)
        drv.close()
        eng.close()
        shutil.rmtree(root, ignore_errors=True)
        spans = tracer.summary()
        runs[f"sync_mode_{sync_mode}"] = {
            "ms_per_inner_step": seconds / (timed * K) * 1e3,
            "committed_cmds_per_s": (committed1 - committed0) / seconds,
            "wal_mb_per_s": (w1["bytes_written"] - w0["bytes_written"])
            / seconds / 1e6,
            "fsyncs": w1["syncs"] - w0["syncs"],
            "readback_share": (w1["readback_bytes"] - w0["readback_bytes"])
            / max(1, w1["readback_bytes_full"] - w0["readback_bytes_full"]),
            "wall_ms_per_dispatch": seconds / timed * 1e3,
            "cpu_ms_per_dispatch": {
                k: (cpu1[k] - cpu0[k]) / timed * 1e3
                for k in cpu1 if k in cpu0 and k != "lock-probe"},
            "process_cpu_ms_per_dispatch": (proc1 - proc0) / timed * 1e3,
            "spans_ms_per_dispatch": {
                k: v["total_us"] / 1e3 / timed for k, v in spans.items()
                if k != "_meta"},
            "lock_probe": lock}
    emit({"phase": "durable_diagnosis", "lanes": N, "members": P,
          "superstep_k": K, "cmds_per_step": cmds, "timed_dispatches": timed,
          "wal_shards": shards, "max_pending": 32, **runs})


# -- the order-dependent machines --------------------------------------------

def fold_commands(kind: str, rng, n: int, a: int, S: int) -> np.ndarray:
    """A [n, a, C] window holding every op of the machine, out-of-range
    keys, negative values and int32 overflow on add."""
    shape = (n, a)
    if kind == "fifo":
        # consumer ops (7-11) name a few pids, so consumers own several
        # rows when they are cancelled; settle and return name ids
        op = rng.integers(0, 13, shape)
        arg = np.where((op >= 7) & (op <= 11), rng.integers(-1, 6, shape),
                       rng.integers(-1, 40, shape))
        return np.stack([op, arg, rng.integers(0, 4, shape)],
                        -1).astype(np.int32)
    # small values, so that cas expectations match and -1 (delete on a
    # matching cas) comes up; a few at the int32 edges
    value = rng.integers(-3, 12, shape)
    value = np.where(rng.random(shape) < 0.05,
                     rng.choice([2 ** 31 - 1, -2 ** 31], shape), value)
    last = rng.integers(-2, 12, shape)
    if kind == "ttl_kv":
        last = np.where(rng.random(shape) < 0.05, 2 ** 31 - 1, last)
    return np.stack([rng.integers(0, 6, shape), rng.integers(-3, S + 3, shape),
                     value, last], -1).astype(np.int32)


#: int32 edges and near-zero values the stream windows start from
STREAM_EDGE = np.array([0, 3, 2 ** 31 - 2, 2 ** 31 - 1, -2 ** 31, -7],
                       np.int64)


def stream_state(rng, lead: tuple, Q: int, G: int) -> dict:
    """StreamMachine states (numpy int32) with leading dims ``lead``: tails
    and bases at the int32 edges and negative (a tail's slot is then a
    floor mod, and its next append wraps), cursors anywhere."""
    tail = wrap32(rng.choice(STREAM_EDGE, lead) + rng.integers(-2, 3, lead))
    base = wrap32(np.where(rng.random(lead) < 0.5,
                           tail.astype(np.int64) - Q,
                           rng.choice(STREAM_EDGE, lead)))
    return {"buf": rng.integers(-5, 100, lead + (Q,)).astype(np.int32),
            "tail": tail, "base": base,
            "cursors": rng.choice(STREAM_EDGE, lead + (G,)).astype(np.int32)}


def stream_commands(rng, shape: tuple, G: int, clean: bool) -> np.ndarray:
    """[..., 3] StreamMachine commands: appends (some of negative values,
    invalid), and unless ``clean`` cursor commits (bad groups, offsets
    past the tail and at the int32 edges), truncates and unknown ops."""
    op = rng.integers(0, 2 if clean else 5, shape)
    a = np.where(rng.random(shape) < 0.15, -1, rng.integers(0, 90, shape))
    a = np.where(op == 2, rng.integers(-1, G + 2, shape), a)
    a = np.where((op == 3) & (rng.random(shape) < 0.3),
                 rng.choice(STREAM_EDGE, shape), a)
    b = np.where(rng.random(shape) < 0.2, rng.choice(STREAM_EDGE, shape),
                 rng.integers(-5, 90, shape))
    return np.stack([op, a, b], -1).astype(np.int32)


def wrap32(x) -> np.ndarray:
    """Integers cut to int32 as two's complement, as XLA's int32 wraps."""
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 -
            2 ** 31).astype(np.int32)


def fifo_hard_state(rng, n: int, Q: int, K: int, C: int) -> dict:
    """[n, ...] FIFO lane states (numpy int32) at the requeue merge's
    corners: most ready windows full to the capacity beside several
    checked-out rows a consumer, so a return or a cancel merges into a
    full window; a sixth holding the whole capacity ready beside the
    checked-out rows (more than the engine's own commands ever hold, which
    the fold takes all the same: a merge's sources then pass the ring's
    end); a quarter of the heads just below 2^31 and a quarter at
    -2^31, and a quarter of the ticket runs just below 2^31 (the window
    wraps the ring and int32); checked-out tickets between, below and
    above the ready ones, duplicated in a third of the lanes (equal
    ranks); a third of the next ids at 2^31 - 1 (a checkout's id wraps
    negative, and its row reads free)."""
    edge = rng.integers(0, 4, n)
    near = rng.integers(0, 2 * Q + 8, n)
    head = wrap32(np.where(edge == 1, 2 ** 31 - 1 - near,
                           np.where(edge == 2, -2 ** 31 + near,
                                    rng.integers(0, 999, n))))
    n_co = rng.integers(0, min(K, Q) + 1, n)
    roll = rng.random(n)
    size = np.where(roll < 0.6, Q - n_co,
                    np.where(roll < 0.75, Q, rng.integers(0, Q - n_co + 1)))
    mid0 = np.where(rng.random(n) < 0.25, 2 ** 31 - 1 - near,
                    rng.integers(-999, 999, n))
    buf = rng.integers(0, 1000, (n, Q))
    dc = rng.integers(0, 3, (n, Q))
    mid = rng.integers(-50, 50, (n, Q))          # stale slots
    for j in range(Q):                           # ticket order from head
        at = np.flatnonzero(j < size)
        mid[at, wrap32(head[at].astype(np.int64) + j) % Q] = \
            wrap32(mid0[at] + 2 * j + 1)
    k = np.arange(K)[None]
    id0 = np.where(rng.random(n) < 0.3, 2 ** 31 - 1 - 3 * K,
                   rng.integers(0, 999, n))
    co_mid = wrap32(mid0[:, None] + 2 * rng.integers(
        -3, size[:, None] + 4, (n, K)))          # even: between tickets
    owner = rng.integers(0, C + 1, (n, K))       # C: anonymous
    con_pid = np.where(rng.random((n, C)) < 0.8, 2 * np.arange(C)[None], -1)
    for dup, col in ((rng.random(n) < 0.35, 1), (rng.random(n) < 0.15, 2)):
        if col < K:     # a registered consumer owns the equal tickets
            co_mid[dup, col] = co_mid[dup, 0]
            owner[dup, 0] %= C
            owner[dup, col] = owner[dup, 0]
            con_pid[dup, owner[dup, 0]] = 2 * owner[dup, 0]
    state = {
        "buf": buf, "dc": dc, "mid": mid, "head": head,
        "tail": wrap32(head.astype(np.int64) + size),
        "co_id": np.where(k < n_co[:, None], id0[:, None] + 3 * k, -1),
        "co_val": rng.integers(0, 1000, (n, K)),
        "co_dc": rng.integers(0, 3, (n, K)), "co_mid": co_mid,
        "co_owner": owner, "con_pid": con_pid,
        "con_credit": rng.integers(0, K + 2, (n, C)),
        "next_id": np.where(rng.random(n) < 0.3,
                            2 ** 31 - 1 - rng.integers(0, 3, n),
                            id0 + 3 * K),
        "next_mid": wrap32(mid0 + 2 * size + 1),
        "n_dropped": rng.integers(0, 9, n)}
    return {key: wrap32(v) for key, v in state.items()}


def fifo_hard_commands(rng, co_id, next_id, C: int, a: int) -> np.ndarray:
    """An [n, a, 3] FIFO window for ``fifo_hard_state``'s lanes: returns
    and settles of the lane's checked-out ids (``co_id`` [n, K]) and of
    ids its checkouts in the window get (from ``next_id`` [n]), cancels
    and downs of consumers that own several rows, checkouts, enqueues
    that keep the window full, a rare purge, and unknown ids and pids."""
    n, K = co_id.shape
    ops = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12])
    weight = np.array([1, 6, 2, 3, 2, 6, .2, 1, 2, 2, 4, 1, .3])
    op = rng.choice(ops, (n, a), p=weight / weight.sum())
    pick = co_id[np.arange(n)[:, None], rng.integers(0, K, (n, a))]
    fresh = next_id[:, None].astype(np.int64) + rng.integers(0, 4, (n, a))
    ids = np.where((pick >= 0) & (rng.random((n, a)) < 0.7), pick, fresh)
    pids = np.where(rng.random((n, a)) < 0.1, -1,
                    2 * rng.integers(0, C + 1, (n, a)))
    x = np.where((op == 4) | (op == 5), ids,
                 np.where((op >= 7) & (op <= 11), pids,
                          rng.integers(0, 1000, (n, a))))
    return wrap32(np.stack([op, x, rng.integers(0, K + 2, (n, a))], -1))


def fold_operands(machine, kind, n, p, a, rng, dev, state=None,
                  hard=False):
    """(meta, commands, mask, state) of one window on ``dev``: the lane's
    commands through a stride-0 member axis, as the engine passes them.
    ``hard`` (FIFO): a ``fifo_hard_state`` start and ``fifo_hard_commands``
    windows instead of random ones; for the stream, ``hard`` starts from
    ``stream_state``'s int32 edges, and ``"clean"`` also keeps the windows
    to noops and appends."""
    from ra_tpu_torch.core.tree import tree_map
    S = getattr(machine, "n_keys", getattr(machine, "n_slots", 0))
    if kind == "stream":
        if state is None and hard:
            lanes = stream_state(rng, (n,), machine.capacity,
                                 machine.groups)
            state = {k: torch.from_numpy(v).to(dev)[:, None].expand(
                (n, p) + v.shape[1:]).contiguous() for k, v in lanes.items()}
        cmd = torch.from_numpy(stream_commands(
            rng, (n, a), machine.groups, clean=hard == "clean")).to(dev)
    elif hard:
        if state is None:
            lanes = fifo_hard_state(rng, n, machine.capacity,
                                    machine.checkout_slots,
                                    machine.consumer_slots)
            state = {k: torch.from_numpy(v).to(dev)[:, None].expand(
                (n, p) + v.shape[1:]).contiguous() for k, v in lanes.items()}
        cmd = torch.from_numpy(fifo_hard_commands(
            rng, state["co_id"][:, 0].cpu().numpy(),
            state["next_id"][:, 0].cpu().numpy(), machine.consumer_slots,
            a)).to(dev)
    else:
        cmd = torch.from_numpy(fold_commands(kind, rng, n, a, S)).to(dev)
    cmds = cmd[:, None].expand((n, p) + cmd.shape[1:])
    mask = torch.from_numpy(rng.random((n, p, a)) < 0.9).to(dev)
    index = torch.from_numpy((rng.integers(0, 4, (n, 1, a)) +
                              np.arange(a) * 3).astype(np.int32))
    meta = {"index": index.to(dev).expand(n, p, a),
            "term": torch.ones((n, 1, 1), dtype=torch.int32, device=dev)}
    if state is None:
        state = tree_map(lambda x: x[:, None].expand(
            (n, p) + x.shape[1:]).contiguous(), machine.jit_init(n, dev))
    return meta, cmds, mask, state


def fold_bytes(meta, cmds, mask, state, kind) -> int:
    """What the in-order fold must move: each state leaf read and written
    once, the lane's commands once (shared by its members), the mask, and
    for TTL-KV the lane's index row."""
    from ra_tpu_torch.core.tree import tree_leaves
    n, p, a, c = cmds.shape
    state_b = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    idx_b = n * a * 4 if kind == "ttl_kv" else 0
    return 2 * state_b + n * a * c * 4 + n * p * a + idx_b


def fifo_consumer_full(n: int, p: int, dev):
    """(meta, commands, mask, state) of the FIFO consumer mix's window
    (``fifo_mixes`` (b)) on a lane whose ready window is full: the plain
    model of the queue run for 9 steps of the mix, every lane and member
    alike, and step 9's 128 commands plus the apply window's 2 noops."""
    rows = dict((mix, blocks) for mix, _m, blocks, _c in fifo_mixes(1))
    blk = rows["b_consumer"](1)[1][1, 0]          # step 9 = dispatch 1, 1
    oracle = FifoOracle(256, 8, 4)
    for d in range(2):
        for k in range(8 if d == 0 else 1):
            for op, a, _b in rows["b_consumer"](d)[1][k, 0]:
                oracle.apply(int(op), int(a))
    if oracle.tail - oracle.head + sum(i >= 0 for i in oracle.co_id) != 256:
        raise AssertionError("fifo consumer window: the queue is not full")
    cmd = np.zeros((130, 3), np.int32)
    cmd[:128] = blk
    cmds = torch.from_numpy(cmd).to(dev).expand(n, 130, 3).contiguous()
    cmds = cmds[:, None].expand(n, p, 130, 3)     # a copy a lane, as paths
    state = {k: torch.from_numpy(v).to(dev).expand((n, p) + v.shape)
             .contiguous() for k, v in oracle.state().items()}
    meta = {"index": torch.arange(1, 131, dtype=torch.int32, device=dev)
            .expand(n, p, 130),
            "term": torch.ones((n, 1, 1), dtype=torch.int32, device=dev)}
    mask = torch.ones((n, p, 130), dtype=torch.bool, device=dev)
    mask[..., 128:] = False
    return meta, cmds, mask, state


def phase_fold_kernels(dev) -> list:
    """Each fold kernel against its plain version (the machine's
    sequential_window_fold, on the card): at the full widths of the fifo
    and kv paths and at ragged shapes (N not a multiple of a block, P = 1,
    3, 7, 16, A = 1, A > Q), every op, both FIFO overflow policies; for the
    FIFO also the hard windows (``fifo_hard_state``: full ready windows,
    several rows requeued at once, heads and tickets at the int32 edges,
    equal ranks), with Q not a power of two, group widths 8, 16 and 32
    (K, C = 5, 3; 13, 9; 32, 17) and a ring of 5,000 (blocks past 48 KB of
    shared memory); and the tables the kernels fold in device memory: a
    ring of 32,768, 40 consumers, cell files of 9,000-70,000.  Then each
    timed at its path's width,
    the FIFO also on the consumer mix's window at full ready depth."""
    from ra_tpu_torch.core.tree import tree_leaves, tree_map
    from ra_tpu_torch.models import JitFifoMachine, JitKvMachine, \
        RegisterMachine, StreamMachine, TtlKvMachine
    from ra_tpu_torch.ops import _fold, fifo_fold, slot_fold
    # case: (machine, kind, module, shapes, hard windows)
    cases = {
        "registers": (lambda: RegisterMachine(8), "registers", slot_fold,
                      [(10_000, 5, 130), (1_001, 1, 1), (300, 7, 20)],
                      False),
        "kv": (lambda: JitKvMachine(64), "kv", slot_fold,
               [(10_000, 5, 130), (1_001, 3, 40), (129, 16, 33)], False),
        "ttl_kv": (lambda: TtlKvMachine(64), "ttl_kv", slot_fold,
                   [(10_000, 5, 130), (1_001, 1, 1), (300, 7, 20)], False),
        "fifo_reject": (lambda: JitFifoMachine(256, 8, 4), "fifo",
                        fifo_fold, [(5_000, 5, 130)], False),
        "fifo_drop_head": (lambda: JitFifoMachine(256, 8, 4, "drop_head"),
                           "fifo", fifo_fold, [(5_000, 5, 130)], False),
        "fifo_small": (lambda: JitFifoMachine(16, 4, 2), "fifo", fifo_fold,
                       [(1_001, 3, 40), (129, 16, 1), (300, 1, 64)], False),
        "fifo_small_drop_head": (
            lambda: JitFifoMachine(16, 4, 2, "drop_head"), "fifo",
            fifo_fold, [(1_001, 7, 40), (33, 16, 20)], False),
        "fifo_hard": (lambda: JitFifoMachine(256, 8, 4), "fifo", fifo_fold,
                      [(5_000, 5, 130), (1_001, 3, 300)], True),
        "fifo_hard_drop_head": (
            lambda: JitFifoMachine(256, 8, 4, "drop_head"), "fifo",
            fifo_fold, [(5_000, 5, 130), (129, 1, 1)], True),
        "fifo_odd_hard": (lambda: JitFifoMachine(12, 5, 3, "drop_head"),
                          "fifo", fifo_fold,
                          [(1_001, 7, 40), (129, 1, 1), (33, 16, 20)], True),
        "fifo_g16_hard": (lambda: JitFifoMachine(40, 13, 9), "fifo",
                          fifo_fold, [(300, 3, 50), (7, 16, 41)], True),
        "fifo_g32_hard": (lambda: JitFifoMachine(64, 32, 17, "drop_head"),
                          "fifo", fifo_fold, [(129, 3, 70)], True),
        # a ring past 48 KB a block: opted-in shared memory, idle groups
        "fifo_big_ring_hard": (lambda: JitFifoMachine(5_000, 4, 2), "fifo",
                               fifo_fold, [(65, 3, 60)], True),
        # the widest ring kept in shared memory (one row a block), and one
        # past it, folded in device memory
        "fifo_ring_19328_hard": (
            lambda: JitFifoMachine(19_328, 8, 4, "drop_head"), "fifo",
            fifo_fold, [(65, 3, 60)], True),
        "fifo_ring_32768_hard": (lambda: JitFifoMachine(32_768, 8, 4),
                                 "fifo", fifo_fold, [(65, 3, 60)], True),
        # more consumers than a warp has lanes: the table in device memory
        "fifo_consumers_40_hard": (
            lambda: JitFifoMachine(64, 32, 40, "drop_head"), "fifo",
            fifo_fold, [(129, 3, 70)], True),
        "fifo_consumers_40": (lambda: JitFifoMachine(16, 4, 40), "fifo",
                              fifo_fold, [(1_001, 3, 40)], False),
        # cell files too wide for one row in shared memory
        "kv_wide": (lambda: JitKvMachine(20_000), "kv", slot_fold,
                    [(129, 3, 40)], False),
        "ttl_kv_wide": (lambda: TtlKvMachine(9_000), "ttl_kv", slot_fold,
                        [(129, 3, 40)], False),
        "registers_wide": (lambda: RegisterMachine(70_000), "registers",
                           slot_fold, [(33, 3, 30)], False),
        # the stream decoder: random windows of every op (bad groups,
        # negative values, unknown ops), the same from tails and bases at
        # the int32 edges, append-only windows (the reference's fast
        # fold), a ring that is no power of two, A > Q, lane counts that
        # are no multiple of a block's, 9 groups, and a ring too wide for
        # a row in shared memory
        "stream": (lambda: StreamMachine(64, 4), "stream", slot_fold,
                   [(10_000, 5, 130), (1_001, 1, 1), (300, 7, 20)], False),
        "stream_edge": (lambda: StreamMachine(64, 4), "stream", slot_fold,
                        [(10_000, 5, 130), (1_001, 3, 40), (129, 16, 300),
                         (1_003, 1, 70), (333, 5, 1), (41, 16, 150)], True),
        "stream_append_only": (lambda: StreamMachine(64, 4), "stream",
                               slot_fold, [(10_000, 5, 130), (300, 7, 200)],
                               "clean"),
        "stream_odd": (lambda: StreamMachine(5, 2), "stream", slot_fold,
                       [(1_001, 3, 40), (33, 16, 20), (257, 5, 130)], True),
        "stream_g9": (lambda: StreamMachine(64, 9), "stream", slot_fold,
                      [(1_001, 5, 130), (65, 16, 70)], True),
        "stream_wide": (lambda: StreamMachine(30_000, 40), "stream",
                        slot_fold, [(33, 3, 40)], True),
    }

    def check(case, m, mod, meta, cmds, mask, state):
        """The kernel's fold against the plain version's, one launch;
        returns (the plain fold, the largest difference: 0)."""
        want = m.sequential_window_fold(meta, cmds, mask, state)
        before = mod.LAUNCHES
        got = m.in_order_fold(meta, cmds, mask, state)
        torch.cuda.synchronize()
        if mod.LAUNCHES != before + 1:
            raise AssertionError(f"{case}: {mod.LAUNCHES - before} "
                                 "launches for one call")
        err = 0
        for g, t in zip(tree_leaves(got), tree_leaves(want)):
            err = max(err, int((g.long() - t.long()).abs().max()))
            if g.dtype != t.dtype or not torch.equal(g, t):
                raise AssertionError(f"{case} fold kernel != plain version "
                                     f"at {tuple(cmds.shape[:3])}")
        return want, err

    def kernel_call(m, kind, meta, cmds, mask, state):
        """One launch of ``m``'s fold kernel on operands prepared once."""
        c, k_, i_, st, out_k, _out = _fold.kernel_operands(
            meta, cmds, mask, state)
        if kind == "fifo":
            return lambda: fifo_fold.fifo_fold_cuda(
                c, k_, st, out_k, drop_head=m.overflow == "drop_head")
        return lambda: slot_fold.slot_fold_cuda(kind, c, k_, i_, st, out_k)

    def timing(m, kind, meta, cmds, mask, state):
        """The kernel timed a call and back to back beside its bound and
        the plain version; and what holds it: the same launch with the
        state's load and store alone (one command, masked off) and with
        the command stream but no op (the whole window masked off); and
        an empty kernel at the stream decoder's grid (160 threads a 40
        rows), the launch floor."""
        call = kernel_call(m, kind, meta, cmds, mask, state)
        n, p, a = mask.shape
        n_bytes = fold_bytes(meta, cmds, mask, state, kind)
        bound_ms, bound_by = bound(n_bytes, n * p * a * 16)
        off = torch.zeros_like(mask)
        one = {"index": meta["index"][..., :1], "term": meta["term"]}
        return {"shape": [n, p, a], "kernel_ms": cuda_ms(call, reps=50),
                "kernel_graph_ms": graph_ms(call, reps=50),
                "plain_ms": cuda_ms(lambda: m.sequential_window_fold(
                    meta, cmds, mask, state), reps=3, warmup=1),
                "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": bound_by,
                "state_only_graph_ms": graph_ms(kernel_call(
                    m, kind, one, cmds[:, :1, :1].contiguous().expand(
                        n, p, 1, -1), off[..., :1].contiguous(), state),
                    reps=50),
                "no_ops_graph_ms": graph_ms(kernel_call(
                    m, kind, meta, cmds, off, state), reps=50),
                "launch_floor_graph_ms": launch_floor_ms(-(-n * p // 40),
                                                         160)}

    checks, timed = [], {}
    for case, (make, kind, mod, shapes, hard) in cases.items():
        m = make()
        for n, p, a in shapes:
            rng = np.random.default_rng(n + p + a)
            state, err, windows = None, 0, 3
            for w in range(windows):
                meta, cmds, mask, state = fold_operands(
                    m, kind, n, p, a, rng, dev, state, hard=hard)
                state, e = check(case, m, mod, meta, cmds, mask, state)
                err = max(err, e)
            checks.append({"case": case, "shape": [n, p, a],
                           "windows": windows, "exact": True,
                           "max_abs_err": err})
        # time the kernel alone at the path's width, on operands prepared
        # once
        if case in ("registers", "kv", "ttl_kv", "fifo_reject", "fifo_hard",
                    "stream"):
            n, p, a = shapes[0]
            rng = np.random.default_rng(7)
            timed[case] = timing(m, kind, *fold_operands(
                m, kind, n, p, a, rng, dev, hard=hard))
    # a mask with other strides than the engine's (every second column of
    # a wider one): the kernels' byte-by-byte staging
    for case, m, kind, mod in (
            ("kv_strided_mask", JitKvMachine(64), "kv", slot_fold),
            ("ttl_kv_strided_mask", TtlKvMachine(64), "ttl_kv", slot_fold),
            ("fifo_strided_mask", JitFifoMachine(16, 4, 2), "fifo",
             fifo_fold)):
        rng = np.random.default_rng(11)
        meta, cmds, _mask, state = fold_operands(m, kind, 1_001, 3, 40, rng,
                                                 dev)
        mask = torch.from_numpy(rng.random((1_001, 3, 80)) < 0.9).to(dev)
        _want, err = check(case, m, mod, meta, cmds, mask[..., ::2], state)
        checks.append({"case": case, "shape": [1_001, 3, 40], "windows": 1,
                       "exact": True, "max_abs_err": err})
    # the stream at the path's width: an all-masked and a one-command
    # window from the int32 edges
    m = StreamMachine(64, 4)
    meta, cmds, mask, state = fold_operands(
        m, "stream", 10_000, 5, 130, np.random.default_rng(13), dev,
        hard=True)
    for case, msk in (("stream_all_masked", torch.zeros_like(mask)),
                      ("stream_one_command", mask & (torch.arange(
                          130, device=dev) == 77))):
        _want, err = check(case, m, slot_fold, meta, cmds, msk, state)
        checks.append({"case": case, "shape": [10_000, 5, 130],
                       "windows": 1, "exact": True, "max_abs_err": err})
    # the FIFO's costliest window on its path: the consumer mix at full
    # ready depth, where every settle or return meets 255 ready entries
    m = JitFifoMachine(256, 8, 4)
    ops = fifo_consumer_full(5_000, 5, dev)
    _want, err = check("fifo_consumer_full", m, fifo_fold, *ops)
    checks.append({"case": "fifo_consumer_full", "shape": [5_000, 5, 130],
                   "windows": 1, "exact": True, "max_abs_err": err})
    timed["fifo_consumer_full"] = timing(m, "fifo", *ops)
    # capacities that are no power of two, a FIFO of 12 and a stream of
    # 5: the card keeps the reference's choice between the fast and the
    # in-order fold, so clean windows from heads and tails at the int32
    # edge fold as on the CPU (the stream's windows alternate clean and
    # mixed)
    rng = np.random.default_rng(12)
    fifo_lanes = fifo_hard_state(rng, 1_001, 12, 5, 3)

    def fifo_window(w):
        return np.stack([rng.integers(0, 3, (1_001, 40)),
                         rng.integers(0, 1000, (1_001, 40)),
                         np.zeros((1_001, 40), np.int64)],
                        -1).astype(np.int32)
    for case, m, mod, lanes, window in (
            ("fifo_q12_batch_fold_card_vs_cpu", JitFifoMachine(12, 5, 3),
             fifo_fold, fifo_lanes, fifo_window),
            ("stream_q5_batch_fold_card_vs_cpu", StreamMachine(5, 2),
             slot_fold, stream_state(rng, (1_001,), 5, 2),
             lambda w: stream_commands(rng, (1_001, 40), 2,
                                       clean=w % 2 == 0))):
        if not m.fast_fold_on_card:
            raise AssertionError(f"{case}: the card would not keep the "
                                 "reference's fold choice")
        state = {k: torch.from_numpy(v)[:, None].expand(
            (1_001, 3) + v.shape[1:]).contiguous() for k, v in lanes.items()}
        before = mod.LAUNCHES
        for w in range(3):
            cmds = torch.from_numpy(window(w))[:, None].expand(
                1_001, 3, 40, 3)
            mask = torch.from_numpy(rng.random((1_001, 3, 40)) < 0.9)
            meta = {"index": torch.ones((1_001, 3, 40), dtype=torch.int32),
                    "term": torch.ones((), dtype=torch.int32)}
            want = m.jit_apply_batch(meta, cmds, mask, state)
            on = tree_map(lambda x: x.to(dev), (meta, cmds, mask, state))
            got = m.jit_apply_batch(*on)
            if any(not torch.equal(g.cpu(), t) for g, t in
                   zip(tree_leaves(got), tree_leaves(want))):
                raise AssertionError(f"{case}: the card's batch fold != the "
                                     "CPU's at the int32 edge")
            state = want
        checks.append({"case": case, "shape": [1_001, 3, 40], "windows": 3,
                       "exact": True, "max_abs_err": 0,
                       "kernel_launches": mod.LAUNCHES - before})
    # the vectorised fast fold (torch ops) against the kernel on the same
    # window, the paths' bench windows: clean windows, where the
    # reference takes the fast fold and the card runs the kernel
    rng = np.random.default_rng(8)
    fifo_rows = np.zeros((130, 3), np.int32)
    fifo_rows[0::2] = (1, 7, 0)
    fifo_rows[1::2] = (2, 0, 0)
    stream_rows = np.stack([np.ones((10_000, 130)),
                            rng.integers(0, 1000, (10_000, 130)),
                            np.zeros((10_000, 130))], -1).astype(np.int32)
    windows = {
        "stream": (StreamMachine(64, 4), 10_000, stream_rows),
        "kv": (JitKvMachine(64), 10_000, np.stack(
            [rng.integers(1, 3, (10_000, 130)),
             rng.integers(0, 64, (10_000, 130)),
             rng.integers(0, 1000, (10_000, 130)),
             np.zeros((10_000, 130))], -1).astype(np.int32)),
        "fifo": (JitFifoMachine(256, 8, 4), 5_000,
                 np.broadcast_to(fifo_rows, (5_000, 130, 3)))}
    fast_vs_kernel = {}
    for kind, (m, n, win) in windows.items():
        cmd = torch.from_numpy(np.ascontiguousarray(win)).to(dev)
        cmds = cmd[:, None].expand((n, 5) + cmd.shape[1:])
        mask = torch.ones((n, 5, 130), dtype=torch.bool, device=dev)
        meta = {"index": torch.arange(1, 131, dtype=torch.int32,
                                      device=dev).expand(n, 5, 130),
                "term": torch.ones((n, 1, 1), dtype=torch.int32,
                                   device=dev)}
        state = tree_map(lambda x: x[:, None].expand(
            (n, 5) + x.shape[1:]).contiguous(), m.jit_init(n, dev))
        fast = m._batch_fast(cmds, mask, state)
        got = m.in_order_fold(meta, cmds, mask, state)
        if any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(fast), tree_leaves(got))):
            raise AssertionError(f"{kind}: fast fold != fold kernel on the "
                                 "bench window")
        call = kernel_call(m, kind, meta, cmds, mask, state)
        fast_vs_kernel[kind] = {
            "shape": [n, 5, 130], "equal": True,
            "fast_fold_ms": cuda_ms(lambda: m._batch_fast(cmds, mask, state),
                                    reps=20, warmup=2),
            "kernel_ms": cuda_ms(call, reps=50)}
    emit({"phase": "fold_kernels", "checks": checks, "timed": timed,
          "bench_window_fast_fold_vs_kernel": fast_vs_kernel})
    out = []
    for name, case, src, replaces in (
            ("slot_fold", "kv", "ra_tpu_torch/ops/csrc/slot_fold.cu",
             "ra_tpu/core/machine.py:252"),
            ("fifo_fold", "fifo_reject", "ra_tpu_torch/ops/csrc/fifo_fold.cu",
             "ra_tpu/core/machine.py:252")):
        t = timed[case]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces,
                    "exact": True,
                    "max_abs_err": max(c["max_abs_err"] for c in checks),
                    "shape": t["shape"], "ms": t["kernel_ms"],
                    "kernel_ms": t["kernel_ms"],
                    "kernel_graph_ms": t["kernel_graph_ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bytes": t["bytes"], "bound_by": t["bound_by"],
                    # no single PyTorch call computes a machine's fold
                    "library_ms": None})
    out[0]["ttl_kv"] = timed["ttl_kv"]
    out[0]["registers"] = timed["registers"]
    out[0]["stream"] = timed["stream"]
    out[1]["consumer_full"] = timed["fifo_consumer_full"]
    out[1]["hard"] = timed["fifo_hard"]
    return out


def parity_payloads(name: str, rng, k: int, n: int, kc: int) -> np.ndarray:
    """[k, n, kc, C] blocks for ``phase_machine_parity``."""
    shape = (k, n, kc)
    if name == "fifo":
        # consumer mix on every lane: enqueues, dequeues, checkouts,
        # settles, returns, cancels and credit over small ids and pids
        op = rng.choice([1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 10, 11], shape)
        return np.stack([op, rng.integers(0, 12, shape),
                         rng.integers(0, 4, shape)], -1).astype(np.int32)
    if name in ("sequential", "float"):
        return rng.integers(-9, 10, shape + (1,)).astype(np.int32)
    if name == "stream":
        op = rng.choice([0, 1, 1, 1, 2, 3, 4], shape)
        return np.stack([op, rng.integers(-2, 40, shape),
                         rng.integers(-3, 60, shape)], -1).astype(np.int32)
    if name == "dedup":
        # client ops with duplicates, stale replays and bad slots
        return np.stack([rng.integers(-1, 18, shape),
                         rng.integers(0, 12, shape),
                         rng.integers(1, 5, shape)], -1).astype(np.int32)
    op = rng.integers(0, 6, shape)
    return np.stack([op, rng.integers(-2, 18, shape),
                     rng.integers(-2, 60, shape),
                     rng.integers(-1, 6, shape)], -1).astype(np.int32)


def parity_machines():
    """(name, make, fold kernel module or None, reads) for the parity
    phase: the four machines, the stream (its decoder) and the dedup
    counter (torch ops alone), a supports_batch_apply=False counter and a
    float-state machine (the reference's test_scan_machine_float_state_
    exact), both on the sequential apply path."""
    from ra_tpu_torch.core.machine import JitMachine
    from ra_tpu_torch.models import CounterMachine, JitFifoMachine, \
        JitKvMachine, RegisterMachine, StreamMachine, TtlKvMachine
    from ra_tpu_torch.ops import fifo_fold, slot_fold
    from ra_tpu_torch.wire import DedupCounterMachine

    class Sequential(CounterMachine):
        supports_batch_apply = False

    class FloatAcc(JitMachine):
        command_spec = ("int32", (1,))
        supports_batch_apply = False

        def jit_init(self, n_lanes, device):
            return torch.zeros((n_lanes,), dtype=torch.float32,
                               device=device)

        def jit_apply(self, meta, command, state):
            new = state + command[..., 0].to(torch.float32) * 0.5
            return new, new

    return [("registers", lambda: RegisterMachine(8), slot_fold, False),
            ("kv", lambda: JitKvMachine(16), slot_fold, True),
            ("ttl_kv", lambda: TtlKvMachine(16), slot_fold, True),
            ("fifo", lambda: JitFifoMachine(16, 4, 2, "drop_head"),
             fifo_fold, False),
            ("stream", lambda: StreamMachine(8, 3), slot_fold, True),
            ("dedup", lambda: DedupCounterMachine(16), None, False),
            ("sequential", Sequential, None, True),
            ("float", FloatAcc, None, False)]


def phase_machine_parity(LockstepEngine, state_to_numpy, dev) -> None:
    """Each machine on a 64-step seeded schedule (failures, recovery,
    elections inside dispatches, read batches): a card engine stepped
    eagerly and a CPU engine compared after every step, and a card
    engine replaying a K = 8 graph compared after every dispatch, every
    LaneState leaf and aux key; the fold kernel launched once an eager
    step and captured K times in the graph."""
    from ra_tpu_torch.engine.lockstep import step_watermarks
    from ra_tpu_torch.ops import fifo_fold, slot_fold
    N, P, K, kc = 512, 5, 8, 8
    kw = dict(write_delay=1, max_step_cmds=kc, ring_capacity=16,
              apply_window=10, max_step_reads=4, lease_ttl=3,
              read_timeout=6)
    for name, make, mod, reads in parity_machines():
        graph, eager = (LockstepEngine(make(), N, P, device=dev, **kw)
                        for _ in range(2))
        cpu = LockstepEngine(make(), N, P, device="cpu", **kw)
        engines = (graph, eager, cpu)
        rng = np.random.default_rng(len(name))
        failed, eager_launches = [], []
        for d in range(8):
            lanes, failed = churn(engines, cpu.state.leader_slot.numpy(),
                                  failed, rng, N, P, 32)
            n_new = rng.integers(0, kc + 1, (K, N)).astype(np.int32)
            pay = parity_payloads(name, rng, K, N, kc)
            elect = np.zeros((K, N), bool)
            elect[3, lanes[:16]] = True
            elect[6] = rng.random(N) < 0.05
            sched = {"elect_blk": elect,
                     "query_blk": rng.random((K, N)) < 0.2}
            if reads and d % 3 == 1:
                n_read = np.zeros((K, N), np.int32)
                n_read[0] = rng.integers(0, 5, N)
                sched["n_read_blk"] = n_read
                sched["read_q_blk"] = np.stack(
                    [rng.integers(0, 3, (K, N, 4)),
                     rng.integers(-1, 17, (K, N, 4))], -1).astype(np.int32) \
                    if name != "sequential" else \
                    np.zeros((K, N, 4, 1), np.int32)
            auxes = []
            for j in range(K):
                step_kw = {STEP_KW[k]: v[j] for k, v in sched.items()}
                before = mod.LAUNCHES if mod else 0
                aux_e = eager.step(n_new[j], pay[j], **step_kw)
                eager_launches.append((mod.LAUNCHES if mod else 0) - before)
                aux_c = cpu.step(n_new[j], pay[j], **step_kw)
                assert_same(eager, cpu, aux_e, aux_c,
                            f"{name} dispatch {d} step {j}", state_to_numpy)
                auxes.append({**aux_c, **step_watermarks(cpu.state)})
            aux_g = graph.superstep(n_new, pay, **sched)
            torch.cuda.synchronize()
            want = {k: torch.stack([a[k] for a in auxes]).numpy()
                    for k in auxes[0]}
            assert_arrays(host_aux(aux_g), want, f"{name} dispatch {d} "
                          "graph aux")
            assert_arrays(state_to_numpy(graph.state),
                          state_to_numpy(cpu.state),
                          f"{name} dispatch {d} graph state")
        want_launch = 1 if mod else 0
        if set(eager_launches) != {want_launch}:
            raise AssertionError(f"{name}: fold launches a step "
                                 f"{sorted(set(eager_launches))}")
        captured = [g.captured_launches for g in
                    graph._graphs._graphs.values()]
        for c in captured:
            if c["commit_phase"] != K or \
                    c["slot_fold"] != (K if mod is slot_fold else 0) or \
                    c["fifo_fold"] != (K if mod is fifo_fold else 0):
                raise AssertionError(f"{name}: captured launches {c}")
        st = cpu.state
        if int(st.telem.leader_changes.sum()) == 0 or \
                cpu.committed_total() == 0 or \
                (reads and int(st.read_served.sum()) == 0):
            raise AssertionError(f"{name}: the schedule moved no leader, "
                                 "committed nothing or served no read")
        emit({"phase": "machine_parity", "machine": name,
              "engine_machine": graph.overview(0)["machine"],
              "lanes": N, "members": P, "superstep_k": K,
              "steps": 8 * K, "equal_every_step": True,
              "graph_equal_every_dispatch": True,
              "fold_launches_per_eager_step": want_launch,
              "captured_launches": captured,
              "leader_changes": int(st.telem.leader_changes.sum()),
              "committed": cpu.committed_total(),
              "reads_served": int(st.read_served.sum())})


class FifoOracle:
    """A plain model of one lane's JitFifoMachine for ops 0-5 under the
    reject policy: the ring, written slot by slot as the machine writes
    it, so the whole state (stale slots included) can be compared."""

    def __init__(self, Q: int, K: int, C: int) -> None:
        self.Q, self.C = Q, C
        self.buf, self.dc, self.mid = [0] * Q, [0] * Q, [0] * Q
        self.co_id = [-1] * K
        self.co_val, self.co_dc, self.co_mid = [0] * K, [0] * K, [0] * K
        self.co_owner = [0] * K
        self.head = self.tail = self.next_id = self.next_mid = 0
        self.admitted = 0

    def apply(self, op: int, a: int) -> None:
        Q = self.Q
        size = self.tail - self.head
        checked = sum(i >= 0 for i in self.co_id)
        if op == 1 and size + checked < Q:
            s = self.tail % Q
            self.buf[s], self.dc[s], self.mid[s] = a, 0, self.next_mid
            self.tail += 1
            self.next_mid += 1
            self.admitted += 1
        elif op == 2 and size > 0:
            self.head += 1
        elif op == 3 and size > 0 and -1 in self.co_id:
            k, s = self.co_id.index(-1), self.head % Q
            self.co_val[k], self.co_dc[k] = self.buf[s], self.dc[s]
            self.co_mid[k], self.co_owner[k] = self.mid[s], self.C
            self.co_id[k] = self.next_id
            self.next_id += 1
            self.head += 1
        elif op in (4, 5) and a >= 0 and a in self.co_id:
            k = self.co_id.index(a)
            self.co_id[k] = -1
            if op == 5:        # back into the ready window at ticket rank
                ready = [((self.head + j) % Q) for j in range(size)]
                ready = [(self.buf[s], self.dc[s], self.mid[s])
                         for s in ready]
                item = (self.co_val[k], self.co_dc[k] + 1, self.co_mid[k])
                ready.insert(sum(m < item[2] for _v, _d, m in ready), item)
                self.head -= 1
                for j, (v, d, m) in enumerate(ready):
                    s = (self.head + j) % Q
                    self.buf[s], self.dc[s], self.mid[s] = v, d, m
        elif op not in (0, 1, 2, 3, 4, 5):
            raise ValueError(f"op {op} is not modelled")

    def state(self) -> dict:
        """The machine's state leaves for one lane (numpy int32)."""
        return {k: np.asarray(v, np.int32) for k, v in {
            "buf": self.buf, "dc": self.dc, "mid": self.mid,
            "head": self.head, "tail": self.tail, "co_id": self.co_id,
            "co_val": self.co_val, "co_dc": self.co_dc,
            "co_mid": self.co_mid, "co_owner": self.co_owner,
            "next_id": self.next_id, "next_mid": self.next_mid,
            "n_dropped": 0, "con_pid": [-1] * self.C,
            "con_credit": [0] * self.C}.items()}


def kv_oracle(pattern: np.ndarray, steps: int, S: int) -> np.ndarray:
    """A plain model of JitKvMachine: each lane's [L, 4] ``pattern`` of
    commands applied ``steps`` times in order, vectorised over lanes;
    returns the cells [N, S].  Stops early at a fixed point (a step that
    leaves every cell as it found it leaves it so for good)."""
    N, L, _ = pattern.shape
    vals = np.full((N, S), -1, np.int32)
    rows = np.arange(N)
    for _ in range(steps):
        before = vals.copy()
        for j in range(L):
            op, key, v, x = pattern[:, j].T
            ok = (key >= 0) & (key < S)
            k = np.clip(key, 0, S - 1)
            cur = vals[rows, k]
            put = (op == 1) & ok & (v >= 0)
            dele = (op == 3) & ok
            cas = (op == 4) & ok & (v >= -1) & (cur == x)
            new = np.where(put, v, np.where(dele, -1, np.where(cas, v, cur)))
            w = put | dele | cas
            vals[rows[w], k[w]] = new[w]
        if np.array_equal(vals, before):
            break
    return vals


def ttl_oracle(pattern: np.ndarray, steps: int, S: int) -> dict:
    """A plain model of TtlKvMachine over the same repeated pattern: the
    log index of command j of step t is t * L + j + 1 (no elections, so
    no term-opening noops); returns vals, exp, watch [N, S], clock [N]."""
    N, L, _ = pattern.shape
    vals = np.full((N, S), -1, np.int32)
    exp = np.zeros((N, S), np.int32)
    watch = np.zeros((N, S), np.int32)
    rows = np.arange(N)
    clock = 0
    for t in range(steps):
        for j in range(L):
            clock = max(clock, t * L + j + 1)
            op, key, v, ttl = pattern[:, j].T
            ok = (key >= 0) & (key < S)
            k = np.clip(key, 0, S - 1)
            put = (op == 1) & ok & (v >= 0)
            dele = (op == 3) & ok
            wr = (op == 4) & ok
            vals[rows[put], k[put]] = v[put]
            exp[rows[put], k[put]] = np.where(
                ttl[put] > 0, (clock + ttl[put].astype(np.int64)), 0
            ).astype(np.int32)
            vals[rows[dele], k[dele]] = -1
            watch[rows[wr], k[wr]] += 1
    return {"vals": vals, "exp": exp, "watch": watch,
            "clock": np.full((N,), clock, np.int32)}


def run_machine_path(phase: str, mix: str, machine, fold: str, blocks,
                     check, LockstepEngine, DispatchAheadDriver,
                     n_lanes: int, dev, reads=None) -> dict:
    """A machine's slice at full width: ``n_lanes`` x 5 members, ring
    1,024, 128 commands a lane a step, apply window 130, volatile,
    through DispatchAheadDriver at K = 8: 2 warm, 25 timed and 3 profiled
    dispatches of ``blocks(d)`` (host numpy), one empty dispatch to
    settle, then replica agreement and ``check(leaves, steps)`` (the
    mix's plain model against the machine state leaves).  The fold kernel
    ``fold`` is captured once an inner step.  ``reads(d)``, when given, is the read block riding dispatch d
    (16 reads a lane); ``check`` then also takes ``(served, committed)``:
    each dispatch's observed read outcome and the committed count a lane
    before it.  Returns the launches of every kernel on the path."""
    from ra_tpu_torch.readback import Readback
    N, P, cmds, K = n_lanes, 5, 128, 8
    warm, timed, profiled = 2, 25, 3
    mods = kernel_modules(zero=True)
    kernel = f"{fold}_kernel"
    torch.cuda.reset_peak_memory_stats()
    eng = LockstepEngine(machine, N, P, ring_capacity=1024,
                         max_step_cmds=cmds, apply_window=130,
                         write_delay=1, max_step_reads=16, device=dev)
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    #: with reads: per dispatch d, d - 1's committed counts a lane
    before: dict = {}
    if reads is not None:
        drv.read_obs = collections.deque()    # every dispatch's reads

    def submit(d):
        if reads is None:
            drv.submit(*blocks(d))
            return
        before[d] = drv.submit(*blocks(d), read_blk=reads(d))
        # copy out the counts that have landed, so their pinned buffers
        # go back to the host allocator's pool
        for k, h in before.items():
            if isinstance(h, Readback) and h.is_ready():
                before[k] = h.result().copy()
    d = 0
    for _ in range(warm):
        submit(d)
        d += 1
    drv.drain()
    torch.cuda.synchronize()
    eng.phases.reset_reservoirs()
    committed0 = eng.committed_total()

    def timed_window(d0):
        t0 = time.perf_counter()
        for i in range(timed):
            submit(d0 + i)
        drv.drain()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    seconds, graph_call = traced(lambda: timed_window(d))
    d += timed
    committed1 = eng.committed_total()
    phases = eng.phases.overview()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(profiled):
            submit(d)
            d += 1
        drv.drain()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t1
    sums = device_sums(prof, kernel)
    groups, executions, fold_ms = sums["rows"], sums["executions"], \
        sums["hit_ms"]
    kernel_ms, copy_ms = sums["kernels"], sums["copies"]
    top: dict = {}                  # device ms by kernel name, summed
    for e in groups["kernels"]:
        name = e.key[:80]
        top[name] = top.get(name, 0.0) + e.self_device_time_total / 1e3
    n_blk, p_blk = blocks(0)
    zero_reads = None if reads is None else tuple(
        np.zeros_like(x) for x in reads(0))
    # settle the last commits (the same graph: reads ride as zeros)
    drv.submit(np.zeros_like(n_blk), p_blk, read_blk=zero_reads)
    drv.drain()
    drv.close()
    steps = d * K
    graph = next(iter(eng._graphs._graphs.values()))
    # host launches: the warm-up run before the graph's capture, and the
    # capture; replays launch nothing on the host
    host = {name: mod.LAUNCHES for name, mod in mods.items()}
    launches = {"host": host, "captured_per_graph": graph.captured_launches,
                "profiled_executions": executions,
                "profiled_inner_steps": profiled * K}
    want = {name: 2 * K if name in ("commit_phase", fold) else 0
            for name in mods}
    if host != want or graph.captured_launches != {
            k: v // 2 for k, v in want.items()} or \
            executions != profiled * K:
        raise AssertionError(f"{phase} {mix}: launches {launches}; want "
                             f"{want} on the host and {K} {fold} a "
                             "dispatch")
    per_lane = eng.committed_per_lane()
    if not (per_lane == cmds * steps).all():
        raise AssertionError(f"{phase} {mix}: total_committed != "
                             f"{cmds * steps} on "
                             f"{int((per_lane != cmds * steps).sum())} lanes")
    if not (eng.state.applied.cpu().numpy() == cmds * steps).all():
        raise AssertionError(f"{phase} {mix}: not every member applied "
                             "the whole log")
    mac = eng.machine_states()
    leaves = mac if isinstance(mac, dict) else {"cells": mac}
    for k, v in leaves.items():       # replicas at equal applied agree
        if not (v == v[:, :1]).all():
            raise AssertionError(f"{phase} {mix}: replicas differ on {k}")
    if reads is None:
        extra = check(leaves, steps)
    else:
        served = [o for o in drv.read_obs if "read_done" in o]
        committed = {k: np.asarray(h) for k, h in before.items()
                     if h is not None}
        extra = check(leaves, steps, served, committed)
    inner = timed * K
    ms = seconds / inner * 1e3
    busy = (kernel_ms + copy_ms) / (profiled * K)
    out = {"phase": phase, "mix": mix, "machine": eng.overview(0)["machine"],
           "lanes": N, "members": P, "superstep_k": K,
           "cmds_per_step": cmds, "timed_dispatches": timed,
           "ms_per_inner_step": ms,
           "committed_cmds_per_s": (committed1 - committed0) / seconds,
           "host_graph_call_ms": graph_call,
           "fold_kernel_launches": launches,
           "fold_kernel_ms_per_inner_step": fold_ms / (profiled * K),
           "device_busy_ms_per_inner_step": busy,
           "d2d_copy_ms_per_dispatch": copy_ms / profiled,
           "traced_ms_per_inner_step": traced_s / (profiled * K) * 1e3,
           "device_idle_share_untraced": 1.0 - busy / ms,
           "top_kernels_ms_per_inner_step": {
               k: v / (profiled * K) for k, v in
               sorted(top.items(), key=lambda kv: -kv[1])[:8]},
           "device_kernels_per_inner_step": sum(
               e.count for e in groups["kernels"]) / (profiled * K),
           "phases_ms": {p: {q: phases[p][q] for q in ("p50_ms", "p99_ms")}
                         for p in ("host_staging", "device_dispatch")},
           "block_mb": p_blk.nbytes / 2**20,
           "capture_ms": graph.capture_ms,
           "graph_held_mb": graph.held_bytes / 2**20,
           "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
           "steps": steps, "replicas_agree": True, **extra}
    emit(out)
    del eng, drv, graph
    torch.cuda.empty_cache()
    return launches


def fifo_mixes(N: int, K: int = 8) -> list:
    """The FIFO path's mixes, ``(mix, machine factory, blocks(d), check)``
    over ``N`` lanes: (a) bench.py's alternation of enqueue 7 and
    dequeue-settled (windows the reference's fast fold takes); (b) a
    consumer mix: a lane's step is 32 repeats of (enqueue, enqueue,
    dequeue-unsettled, settle of the id that dequeue got), every eighth
    settle a return.  Ids are consecutive a lane, so the host knows them,
    and every window needs the in-order fold.  On the card both take
    fifo_fold.cu every window.  Every lane
    runs the same commands; ``check`` holds the replicas against a plain
    model of the queue."""
    from ra_tpu_torch.models import JitFifoMachine
    cmds = 128
    bench = np.zeros((cmds, 3), np.int32)
    bench[0::2] = (1, 7, 0)
    bench[1::2] = (2, 0, 0)

    def consumer_rows(s):
        g = s * 32 + np.arange(32)               # repeats so far
        rows = np.zeros((32, 4, 3), np.int32)
        rows[:, 0, 0] = rows[:, 1, 0] = 1
        rows[:, 0, 1] = g % 1000
        rows[:, 1, 1] = (g + 500) % 1000
        rows[:, 2, 0] = 3
        rows[:, 3, 0] = np.where(g % 8 == 7, 5, 4)
        rows[:, 3, 1] = g
        return rows.reshape(cmds, 3)

    def blocks_of(rows_of_step):
        def blocks(d):
            blk = np.stack([rows_of_step(d * K + j) for j in range(K)])
            return (np.full((K, N), cmds, np.int32),
                    np.broadcast_to(blk[:, None], (K, N, cmds, 3)))
        return blocks

    def checker(rows_of_step):
        def check(leaves, steps):
            oracle = FifoOracle(256, 8, 4)
            for s in range(steps):
                for op, a, _b in rows_of_step(s):
                    oracle.apply(int(op), int(a))
            for k, v in oracle.state().items():
                got = leaves[k]
                if got.dtype != v.dtype or not (got == v).all():
                    raise AssertionError(f"fifo_path: {k} != the plain "
                                         "model's")
            if not (leaves["next_mid"] == oracle.admitted).all() or \
                    not (leaves["tail"] == leaves["next_mid"]).all():
                raise AssertionError("fifo_path: admitted enqueues != "
                                     "next_mid")
            return {"admitted_enqueues": oracle.admitted,
                    "next_mid_equals_admitted": True,
                    "equal_to_plain_model": True,
                    "ready_depth": oracle.tail - oracle.head,
                    "redelivered": sum(oracle.dc)}
        return check

    def make():
        return JitFifoMachine(capacity=256, checkout_slots=8)

    return [(mix, make, blocks_of(rows), checker(rows))
            for mix, rows in (("a_bench", lambda s: bench),
                              ("b_consumer", consumer_rows))]


def phase_fifo_path(LockstepEngine, DispatchAheadDriver, dev,
                    n_lanes: int = 5_000) -> dict:
    """BASELINE.md's FIFO row through the driver: 5,000 x 5,
    JitFifoMachine(256, 8), the two mixes of ``fifo_mixes``."""
    return {mix: run_machine_path(
        "fifo_path", mix, make(), "fifo_fold", blocks, check,
        LockstepEngine, DispatchAheadDriver, n_lanes, dev)
        for mix, make, blocks, check in fifo_mixes(n_lanes)}


def kv_mixes(N: int, K: int = 8) -> list:
    """The KV path's mixes, ``(mix, machine factory, blocks(d), check)``
    over ``N`` lanes: (a) bench.py's put/get mix on JitKvMachine(64) (the
    reference's fast fold); (b) the same with every 16th command a cas of
    the key's last put value (the in-order fold); (c) TtlKvMachine(64)
    with put (ttl 0-64), get, delete and watch (always the in-order
    fold).  On the card every window of every mix takes slot_fold.cu.
    Each lane repeats its own 128
    commands every step; ``check`` holds the replicas against a plain
    model (for TTL-KV on 512 sampled lanes)."""
    from ra_tpu_torch.models import JitKvMachine, TtlKvMachine
    cmds, S = 128, 64
    rng = np.random.default_rng(0)
    bench = np.zeros((N, cmds, 4), np.int32)
    bench[..., 0] = rng.integers(1, 3, (N, cmds))        # put/get
    bench[..., 1] = rng.integers(0, 64, (N, cmds))
    bench[..., 2] = rng.integers(0, 1000, (N, cmds))
    cas = bench.copy()
    last = np.full((N, S), -1, np.int32)      # a key's last put so far
    lanes = np.arange(N)
    for j in range(cmds):
        op, key, v = cas[:, j, 0], cas[:, j, 1], cas[:, j, 2]
        if j % 16 == 15:
            cas[:, j] = np.stack([np.full(N, 4), key, (v + 1) % 1000,
                                  last[lanes, key]], -1)
        else:
            put = op == 1
            last[lanes[put], key[put]] = v[put]
    ttl = np.stack([rng.choice([1, 1, 2, 3, 4], (N, cmds)),
                    rng.integers(0, 64, (N, cmds)),
                    rng.integers(0, 1000, (N, cmds)),
                    rng.integers(0, 65, (N, cmds))], -1).astype(np.int32)
    sample = np.linspace(0, N - 1, min(N, 512)).astype(np.int64)

    def blocks_of(pattern):
        return lambda d: (np.full((K, N), cmds, np.int32),
                          np.broadcast_to(pattern, (K, N, cmds, 4)))

    def kv_check(pattern):
        def check(leaves, steps):
            want = kv_oracle(pattern, steps, S)
            if not (leaves["cells"] == want[:, None]).all():
                raise AssertionError("kv_path: cells != the plain model's")
            return {"equal_to_plain_model": True,
                    "present_cells": int((want >= 0).sum())}
        return check

    def ttl_check(leaves, steps):
        want = ttl_oracle(ttl[sample], steps, S)
        for k, v in want.items():
            if not (leaves[k][sample] == v[:, None]).all():
                raise AssertionError(f"kv_path ttl: {k} != the plain "
                                     "model's")
        return {"equal_to_plain_model_lanes": len(sample),
                "clock": int(want["clock"][0])}

    return [("a_bench", lambda: JitKvMachine(S), blocks_of(bench),
             kv_check(bench)),
            ("b_cas", lambda: JitKvMachine(S), blocks_of(cas),
             kv_check(cas)),
            ("c_ttl_kv", lambda: TtlKvMachine(S), blocks_of(ttl),
             ttl_check)]


def phase_kv_path(LockstepEngine, DispatchAheadDriver, dev,
                  n_lanes: int = 10_000) -> dict:
    """10,000 x 5 through the driver, the three mixes of ``kv_mixes``."""
    return {mix: run_machine_path(
        "kv_path", mix, make(), "slot_fold", blocks, check,
        LockstepEngine, DispatchAheadDriver, n_lanes, dev)
        for mix, make, blocks, check in kv_mixes(n_lanes)}

class StreamModel:
    """A plain numpy model of StreamMachine over N lanes (offsets in
    int64, far from the int32 edge on this path): the ring, tail, base
    and cursors, one command a lane at a time, and the three queries."""

    def __init__(self, n: int, Q: int, G: int) -> None:
        self.Q, self.G = Q, G
        self.rows = np.arange(n)
        self.buf = np.zeros((n, Q), np.int64)
        self.tail = np.zeros(n, np.int64)
        self.base = np.zeros(n, np.int64)
        self.cursors = np.zeros((n, G), np.int64)

    def apply(self, cmd: np.ndarray) -> None:
        """One command a lane: ``cmd`` [N, 3]."""
        op, a, b = (cmd[:, i].astype(np.int64) for i in range(3))
        rows = self.rows
        app = (op == 1) & (a >= 0)
        self.buf[rows[app], self.tail[app] % self.Q] = a[app]
        tail = self.tail + app
        commit = (op == 2) & (a >= 0) & (a < self.G)
        g = np.clip(a, 0, self.G - 1)
        cur = np.minimum(np.maximum(np.maximum(self.cursors[rows, g], b),
                                    0), tail)
        self.cursors[rows[commit], g[commit]] = cur[commit]
        trunc = op == 3
        self.base = np.where(trunc, np.minimum(np.maximum(
            np.maximum(self.base, a), 0), tail), self.base)
        self.base = np.maximum(self.base, tail - self.Q)
        self.tail = tail

    def query(self, lanes: np.ndarray, q: np.ndarray) -> np.ndarray:
        """Replies [len(lanes), Kr, 2] to queries ``q`` [len(lanes), Kr,
        2]."""
        op, a = q[..., 0].astype(np.int64), q[..., 1].astype(np.int64)
        tail, base = self.tail[lanes, None], self.base[lanes, None]
        ok = (a >= base) & (a < tail)
        val = self.buf[lanes[:, None], np.clip(a, 0, None) % self.Q]
        g_ok = (a >= 0) & (a < self.G)
        cur = self.cursors[lanes[:, None], np.clip(a, 0, self.G - 1)]
        code = np.where(op == 0, tail, np.where(op == 1, ok, g_ok))
        value = np.where(op == 0, base, np.where(
            op == 1, np.where(ok, val, -1), np.where(g_ok, cur, -1)))
        return np.stack([code, value], -1)

    def state(self) -> dict:
        return {"buf": self.buf, "tail": self.tail, "base": self.base,
                "cursors": self.cursors}


def stream_mixes(N: int, seed: int, K: int = 8, dispatches: int = 30) -> list:
    """The stream path's mixes, ``(mix, blocks(d), reads or None,
    check)`` over ``N`` lanes of StreamMachine() (a ring of 64, 4
    groups), 128 commands a lane a step, values from ``seed``: (a) the
    firehose, appends of non-negative values only (windows the
    reference's fast fold takes); (b) the consumer mix, per 16 commands
    12 appends, 2 cursor commits of a group in [0, 4) to an offset within
    the last 2Q or up to 8 past the tail, 1 truncate to the tail less
    Q/2 and 1 invalid op (a bad group or a negative value), each lane its
    own order and values, with 16 reads a lane riding every dispatch
    (read(offset) over [base - 8, tail + 8), cursor(g) and bounds()).
    A lane's step pattern repeats with its offsets moved by the tail's
    advance a step (96 appends).  Every block and read block of the
    ``dispatches`` a path runs is made before it starts (3.5 GB for (b)),
    so the timed loop only hands them to the driver.  ``check`` holds the
    replicas' final
    state, and for (b) every served read at its watermark, against
    ``StreamModel``; a read served below the count committed before it
    was registered is a stale serve."""
    cmds, Q, G = 128, 64, 4
    rng = np.random.default_rng(seed)
    lanes = np.arange(N)
    fire = np.zeros((N, cmds, 3), np.int32)
    fire[..., 0] = 1
    fire[..., 1] = rng.integers(0, 1 << 20, (N, cmds))
    # the consumer pattern: kinds per 16 (0 append, 1 commit, 2 truncate,
    # 3 invalid), each lane its own order
    kinds = np.tile(np.array([0] * 12 + [1, 1, 2, 3]), (N, cmds // 16))
    kinds = rng.permuted(kinds.reshape(N, cmds // 16, 16), axis=2)
    kinds = kinds.reshape(N, cmds)
    bad_group = rng.random((N, cmds)) < 0.5
    op = np.select([kinds == 0, kinds == 1, kinds == 2],
                   [1, 2, 3], np.where(bad_group, 2, 1))
    app = (kinds == 0)
    rel = np.cumsum(app, axis=1) - app          # appends before, a step
    advance = int(app.sum(axis=1)[0])           # 96 a step, every lane
    a = np.select([kinds == 0, kinds == 1, kinds == 2],
                  [rng.integers(0, 1 << 20, (N, cmds)),
                   rng.integers(0, G, (N, cmds)), rel - Q // 2],
                  np.where(bad_group, rng.choice([-1, G], (N, cmds)),
                           -rng.integers(1, 9, (N, cmds))))
    b = np.where(kinds == 1, rel + rng.integers(-2 * Q, 9, (N, cmds)),
                 rng.integers(0, 9, (N, cmds)))
    consumer = np.stack([op, a, b], -1).astype(np.int64)
    moves = np.stack([np.zeros_like(kinds), (kinds == 2).astype(np.int64),
                      (kinds == 1).astype(np.int64)], -1)

    def consumer_step(t):
        """[N, 128, 3] commands of step t: offsets moved by the tail."""
        return (consumer + moves * (t * advance)).astype(np.int32)

    n_full = np.full((K, N), cmds, np.int32)
    fire_blk = np.broadcast_to(fire, (K, N, cmds, 3))
    consumer_blks = [np.stack([consumer_step(d * K + j) for j in range(K)])
                     for d in range(dispatches)]
    # the reads of dispatch d: 16 a lane at inner step 0
    queries = np.zeros((dispatches, N, 16, 2), np.int32)
    for d in range(dispatches):
        r = np.random.default_rng([seed, d])
        tail = d * K * advance
        kind = r.integers(0, 8, (N, 16))
        queries[d, ..., 0] = np.where(kind < 5, 1,
                                      np.where(kind < 7, 2, 0))
        queries[d, ..., 1] = np.where(
            kind < 5, r.integers(max(tail - Q - 8, -8), tail + 8, (N, 16)),
            r.integers(-1, G + 1, (N, 16)))
    n_read = np.zeros((K, N), np.int32)
    n_read[0] = 16
    read_blks = []
    for d in range(dispatches):
        q = np.zeros((K, N, 16, 2), np.int32)
        q[0] = queries[d]
        read_blks.append((n_read, q))

    def reads(d):
        return read_blks[d]

    def model_run(step_rows, steps, at=None):
        """The model through ``steps`` steps; ``at`` maps a command count
        to a callback run on the model at that count."""
        m = StreamModel(N, Q, G)
        for t in range(steps):
            rows = step_rows(t)
            for j in range(cmds):
                m.apply(rows[:, j])
                if at and (t * cmds + j + 1) in at:
                    at[t * cmds + j + 1](m)
        return m

    def final_check(leaves, m, what):
        for k, v in m.state().items():
            if not (leaves[k].astype(np.int64) == v[:, None]).all():
                raise AssertionError(f"stream_path {what}: {k} != the "
                                     "plain model's")

    def fire_check(leaves, steps):
        m = model_run(lambda t: fire, steps)
        final_check(leaves, m, "firehose")
        return {"equal_to_plain_model": True,
                "tail": int(m.tail[0]), "base": int(m.base[0])}

    def consumer_check(leaves, steps, served, committed):
        """Walk the dispatches' read outcomes in order: a lane's batch
        registers at inner step 0 when none is pending (else it is shed
        on arrival), and the served replies are the pending batch's."""
        pending = np.full(N, -1, np.int64)
        prev_shed = prev_stale = np.zeros(N, np.int64)
        mismatch = 0
        by_wm: dict = {}       # watermark -> [(lanes, queries, replies)]
        stats = {"served_reads": 0, "served_batches": 0, "shed": 0,
                 "stale_refused": 0, "stale_serves": 0}
        for d, obs in enumerate(served):
            arriving = d < len(served) - 1     # the last: settle, no reads
            if arriving and d >= dispatches:
                raise AssertionError("stream_path: more dispatches than "
                                     "read blocks made")
            shed = obs["read_shed_lanes"].astype(np.int64)
            stale = obs["read_stale_lanes"].astype(np.int64)
            arrive = pending < 0
            done = obs["read_done"] > 0                 # [K, N]
            hit = done.any(axis=0)
            if arriving:
                pending = np.where(arrive, d, pending)
                stats["shed"] += int((~arrive).sum())
                # the engine sheds a batch that finds its lane's slot busy
                mismatch += int(((shed - prev_shed) != 16 * ~arrive).sum())
            got = np.flatnonzero(hit)
            if len(got):
                k = np.argmax(done[:, got], axis=0)
                wm = obs["read_watermark"][k, got].astype(np.int64)
                rep = obs["read_replies"][k, got]
                src = pending[got]
                if (src < 0).any():
                    raise AssertionError("stream_path: a read served with "
                                         "no batch pending")
                floor = np.array([committed[s][lane] if s in committed
                                  else 0 for s, lane in zip(src, got)])
                stats["stale_serves"] += int((wm < floor).sum())
                for w in np.unique(wm):
                    sel = wm == w
                    by_wm.setdefault(int(w), []).append(
                        (got[sel], queries[src[sel], got[sel]], rep[sel]))
                stats["served_reads"] += 16 * len(got)
                stats["served_batches"] += len(got)
                pending[got] = -1
            expired = stale > prev_stale
            stats["stale_refused"] += int(expired.sum())
            pending[expired] = -1
            prev_shed, prev_stale = shed, stale
        if stats["stale_serves"] or mismatch:
            raise AssertionError(f"stream_path: stale serves or shed "
                                 f"batches the walk did not expect: {stats}"
                                 f", {mismatch} lanes")
        if not by_wm:
            raise AssertionError("stream_path: no read was served")

        def checker(w):
            def at(m):
                for lanes_w, qs, rep in by_wm[w]:
                    want = m.query(lanes_w, qs)
                    if not (rep.astype(np.int64) == want).all():
                        raise AssertionError(
                            f"stream_path: a read served at watermark {w}"
                            " != the plain model's")
            return at
        m = model_run(consumer_step, steps,
                      at={w: checker(w) for w in by_wm})
        final_check(leaves, m, "consumer")
        return {"equal_to_plain_model": True,
                "reads_equal_to_model_at_watermark": True,
                "watermarks_checked": len(by_wm), **stats,
                "tail": int(m.tail[0]), "base_lane0": int(m.base[0]),
                "cursors_lane0": m.cursors[0].tolist()}

    return [("a_firehose", lambda d: (n_full, fire_blk), None, fire_check),
            ("b_consumer", lambda d: (n_full, consumer_blks[d]), reads,
             consumer_check)]


def phase_stream_path(LockstepEngine, DispatchAheadDriver, dev, seed: int,
                      n_lanes: int = 10_000) -> dict:
    """10,000 x 5 StreamMachine() through the driver at K = 8, the two
    mixes of ``stream_mixes``; on the card every window takes the stream
    decoder of slot_fold.cu."""
    from ra_tpu_torch.models import StreamMachine
    t0 = time.perf_counter()
    out = {mix: run_machine_path(
        "stream_path", mix, StreamMachine(), "slot_fold", blocks, check,
        LockstepEngine, DispatchAheadDriver, n_lanes, dev, reads=reads)
        for mix, blocks, reads, check in stream_mixes(n_lanes, seed)}
    emit({"phase": "stream_path_done", "seconds": time.perf_counter() - t0})
    return out


class WaveTrace:
    """A soak's ``on_wave`` hook: each wave's start time (and the
    drain's) in ``starts``, and a torch.profiler window over waves
    [first, last)."""

    def __init__(self, first: int, last: int) -> None:
        self.first, self.last = first, last
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.starts: list = []

    def __call__(self, w: int) -> None:
        if w in (self.first, self.last):
            torch.cuda.synchronize()
            (self.prof.start if w == self.first else self.prof.stop)()
        self.starts.append(time.perf_counter())

    def busy(self) -> tuple:
        """(window seconds, device-busy seconds, idle share): kernels and
        copies from the profile, against the window's wall time."""
        sums = device_sums(self.prof)
        busy = (sums["kernels"] + sums["copies"]) / 1e3
        wall = self.starts[self.last] - self.starts[self.first]
        return wall, busy, 1.0 - busy / wall


def phase_wire_path(dev, n_lanes: int = 1024, waves: int = 12,
                    traced: int = 3) -> dict:
    """``run_wire_soak`` at ``bench.py --wire``'s defaults on the card:
    100,000 loopback connections and 32 socket connections of 16 ops,
    1,024 lanes x 3, 12 waves of 50,000 ops, rings of 32 records, durable
    on open_engine with 2 WAL shards under build/, K = 4 and 16 commands
    a step, a reconnect storm of a quarter of the connections mid-run,
    DedupCounterMachine(452).  The soak's own oracle (every lane's
    counter equal to the fleet's expected sums, every ranked op acked,
    every ring drained) holds or it raises; the tail row is printed with
    each wave's wall time, the device's idle share over the rung's last
    ``traced`` waves (profiled through the soak's wave hook, so the
    window holds no set-up; their waves' wall times beside the untraced
    ones show the profiler's cost), and the dedup fold's device time at
    the path's window."""
    from ra_tpu_torch import devicewatch
    from ra_tpu_torch.wire import DedupCounterMachine
    from ra_tpu_torch.wire.soak import run_wire_soak
    mods = kernel_modules(zero=True)
    data = WAL_ROOT / "wire"
    shutil.rmtree(data, ignore_errors=True)
    t0 = time.perf_counter()
    wt = WaveTrace(waves - traced, waves)
    row = run_wire_soak(0, durable_dir=str(data), device=dev,
                        conns=100_000, lanes=n_lanes, waves=waves,
                        wave_ops=50_000, ring_records=32, socket_conns=32,
                        socket_ops=16, superstep_k=4, cmds=16, wal_shards=2,
                        on_wave=wt)
    seconds = time.perf_counter() - t0
    launches = used_only("wire_path", mods, "commit_phase")
    shutil.rmtree(data, ignore_errors=True)
    wave_s = np.diff(wt.starts).tolist()
    traced_s, busy_s, idle = wt.busy()
    if row["dup_rows_absorbed"] <= 0 or row["storm_requeued"] <= 0:
        raise AssertionError("wire_path: the storm made no duplicate to "
                             "absorb")
    # the dedup fold (torch ops, no kernel) at the path's window:
    # [1,024, 3, 18] commands, 452 slots a lane
    m = DedupCounterMachine(slots=4 * (100_032 // n_lanes) + 64)
    rng = np.random.default_rng(0)
    state = {"value": torch.zeros((n_lanes, 3), dtype=torch.int32,
                                  device=dev),
             "seq": torch.from_numpy(rng.integers(
                 0, 50, (n_lanes, 3, m.slots)).astype(np.int32)).to(dev)}
    cmd = torch.from_numpy(np.stack([
        rng.integers(0, m.slots, (n_lanes, 18)),
        rng.integers(1, 60, (n_lanes, 18)),
        rng.integers(1, 8, (n_lanes, 18))], -1).astype(np.int32)).to(dev)
    cmds = cmd[:, None].expand(n_lanes, 3, 18, 3)
    mask = torch.ones((n_lanes, 3, 18), dtype=torch.bool, device=dev)
    fold = lambda: m.jit_apply_batch(None, cmds, mask, state)  # noqa: E731
    reduced = {} if waves == 12 else {"waves": [12, waves]}
    out = {"phase": "wire_path", "seconds": seconds, "reduced": reduced,
           "launches": launches,
           "dedup_fold_ms_a_call": cuda_ms(fold, reps=50),
           "dedup_fold_graph_ms": graph_ms(fold, reps=50),
           "dedup_fold_shape": [n_lanes, 3, 18, m.slots],
           "wave_s": wave_s, "traced_waves": [waves - traced, waves],
           "traced_waves_s": traced_s,
           "traced_waves_device_busy_s": busy_s,
           "traced_waves_device_idle_share": idle,
           **{k: row[k] for k in (
               "wire_cmds_per_s", "wire_shed_rate",
               "wire_reconnect_recovery_s", "elapsed_s", "work_s",
               "wire_conns", "wire_swept_rows", "conns", "sessions",
               "lanes", "socket_conns", "ops", "dup_rows_absorbed",
               "storm_requeued", "durable", "wal_shards",
               "wire_shed_fairness")},
           "device_plane": devicewatch.bench_tail_keys(row["ops"]),
           "exactly_once_lane_sums": True, "ranked_ops_acked": True}
    emit(out)
    return {"host": launches}


# -- the observability and control loop: tune_path and reads_path -----------

def kernel_modules(zero: bool = False) -> dict:
    """The four kernels' wrapper modules by name; ``zero`` sets every
    launch count to 0 (a path's count starts just before it)."""
    from ra_tpu_torch.ops import commit_phase, fifo_fold, pallas_quorum, \
        slot_fold
    mods = {"evaluate_quorum": pallas_quorum, "commit_phase": commit_phase,
            "slot_fold": slot_fold, "fifo_fold": fifo_fold}
    for m in mods.values() if zero else ():
        m.LAUNCHES = 0
    return mods


def used_only(phase: str, mods: dict, *used: str) -> dict:
    """Every kernel's launches since ``mods`` (the modules, or the counts)
    were zeroed; raise unless the kernels ``used`` launched and no other
    did."""
    launches = {name: getattr(m, "LAUNCHES", m) for name, m in mods.items()}
    if any((n > 0) != (name in used) for name, n in launches.items()):
        raise AssertionError(f"{phase} launches {launches}; want {used}")
    return launches


def phase_shares(rates: dict) -> dict:
    """Each latency phase's share of one Observatory window's phase time,
    from ``window_rates`` of the monotone ``total_ms`` counters
    (``commit_e2e`` spans the others and is left out, as the autotuner
    leaves it out)."""
    pre, suf = "engine_phases_", "_total_ms"
    ms = {k[len(pre):-len(suf)]: v for k, v in rates.items()
          if k.startswith(pre) and k.endswith(suf) and v > 0}
    ms.pop("commit_e2e", None)
    total = sum(ms.values())
    return {p: v / total for p, v in sorted(ms.items())} if total else {}


def prometheus_round_trip(obs, parse_prometheus) -> dict:
    """A fresh snapshot's Prometheus text, parsed, against the ring's
    newest flattening: every flat key back with its value, and no other
    unlabelled name but the commit-lag histogram's count."""
    snap = obs.snapshot()
    parsed = parse_prometheus(obs.prometheus(snap))
    newest = obs.ring()[-1][1]
    bad = {k: (v, parsed.get(("ra_tpu_" + k, ""))) for k, v in newest.items()
           if parsed.get(("ra_tpu_" + k, "")) != v}
    extra = {n for n, lbl in parsed if not lbl} - \
        {"ra_tpu_" + k for k in newest} - {"ra_tpu_engine_commit_lag_count"}
    if bad or extra:
        raise AssertionError(f"Prometheus round trip: {len(bad)} values "
                             f"differ ({list(bad.items())[:3]}), extra "
                             f"{sorted(extra)[:3]}")
    return {"keys": len(newest), "lines": len(parsed)}


def tune_loop(dev, wal_dir: str, *, n_lanes: int = 10_000, cmds: int = 128,
              seconds: float = 20.0, k_hi: int = 64,
              shards: int | None = None,
              profile_dir: str | None = None) -> dict:
    """``bench.py``'s durable rung with ``RA_TPU_BENCH_AUTOTUNE=1`` on the
    port: ``CounterMachine``, ``n_lanes`` x 5, ``cmds`` commands a lane a
    step, ring 1,024, apply window cmds + 2, ``open_engine`` with
    ``shards`` WAL shards (``durable_path``'s: min(4, cores / 2)), sync
    mode 1 and ``max_pending = max(8, 4 K)`` at the starting K = 1.  A
    ``TelemetrySampler`` at its default cadence feeds
    ``Observatory.for_engine``; an ``SloEngine`` with the default
    objectives and an ``AutoTuner`` on the engine's durability bridge,
    ``cmds_per_step`` pinned and ``superstep_k`` in (1, ``k_hi``), tick
    every 0.2 s of a ``DispatchAheadDriver`` loop that restages its block
    when K moves (``bench.py``'s restage).  The tuner's cooldown and
    breach windows are 1 and its incident freeze 0, as ``bench.py``'s
    mesh rung sets them, and its capture freeze 1 s.

    Held: after each restage the first dispatch of the new K leaves
    ``overview()["pipeline"]["superstep_k"]`` at that K, and every K
    dispatched is one the tuner decided (no silent turns), and every K it
    decided is dispatched before the freeze probe; after every
    tick each shard's group-commit wait equals the tuner's knob; a
    ``DiskFaultPlan`` installed for two ticks freezes the tuner (one
    ``tune.freeze``, no decision); after drain, flush and settle the
    committed total equals every leader's log, the commands the WAL
    records as accepted, and each member's counter, and it equals lanes x
    cmds x inner steps where the ring clipped nothing; the last
    snapshot's Prometheus text parses back to the ring's newest
    flattening.  With ``profile_dir``, three dispatches at the converged
    K are profiled with ``trace.torch_profile`` (device busy and idle)."""
    from ra_tpu_torch import trace
    from ra_tpu_torch.autotune import AutoTuner
    from ra_tpu_torch.blackbox import RECORDER
    from ra_tpu_torch.devicewatch import WATCH
    from ra_tpu_torch.engine import DispatchAheadDriver
    from ra_tpu_torch.engine.durable import open_engine
    from ra_tpu_torch.log import faults
    from ra_tpu_torch.models import CounterMachine
    from ra_tpu_torch.slo import SloEngine
    from ra_tpu_torch.telemetry import (Observatory, TelemetrySampler,
                                        parse_prometheus)
    N, P, k0 = n_lanes, 5, 1
    shards = shards or max(1, min(4, (os.cpu_count() or 2) // 2))
    shutil.rmtree(wal_dir, ignore_errors=True)
    eng = open_engine(CounterMachine(), wal_dir, N, P, wal_shards=shards,
                      sync_mode=1, max_pending=max(8, 4 * k0),
                      ring_capacity=1024, max_step_cmds=cmds,
                      apply_window=cmds + 2, device=dev)
    sampler = TelemetrySampler(eng)
    obs = Observatory.for_engine(eng, sampler=sampler)
    slo = SloEngine(obs)
    tuner = AutoTuner(slo, obs, durability=eng._dur,
                      bounds={"cmds_per_step": (cmds, cmds),
                              "superstep_k": (1, k_hi)},
                      knobs={"superstep_k": k0, "cmds_per_step": cmds},
                      cooldown_windows=1, breach_windows=1,
                      incident_freeze_s=0.0, compile_freeze_s=1.0)
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    n_host = np.full(N, cmds, np.int32)
    p_host = np.ones((N, cmds, 1), np.int32)

    def blocks(k):
        return (np.broadcast_to(n_host, (k, N)),
                np.broadcast_to(p_host, (k,) + p_host.shape))

    cur = k0
    nb, pb = blocks(cur)
    staged = [None]             # K of the block the driver holds staged
    sent_steps = [0]            # inner steps of every dispatched block
    dispatched: list = []       # each new K's first dispatch
    decided = {k0}              # K values the tuner set
    captures: list = []
    watch = dict(WATCH.counters)

    def submit():
        drv.submit(nb, pb)
        k, staged[0] = staged[0], cur
        if k is None:
            return
        sent_steps[0] += k
        c = WATCH.counters
        if c["compiles"] != watch["compiles"]:
            captures.append({"k": k, "captures": c["compiles"] -
                             watch["compiles"], "recaptures":
                             c["recompiles"] - watch["recompiles"],
                             "ms": c["compile_ms"] - watch["compile_ms"]})
            watch.update(c)
        if not dispatched or dispatched[-1]["k"] != k:
            # the first dispatch of a new K: its stamp, and its decision
            stamp = eng.overview()["pipeline"]["superstep_k"]
            if stamp != k or k not in decided:
                raise AssertionError(f"tune_path: dispatched K = {k}, "
                                     f"stamped {stamp}, decided {decided}")
            dispatched.append({"k": k, "knob": tuner.knobs["superstep_k"],
                               "stamp": stamp})

    for _ in range(2):
        submit()
    drv.drain()
    k, staged[0] = staged[0], None
    sent_steps[0] += k
    sampler.drain()
    decisions: list = []
    rate_by_k: dict = {}        # K -> [committed, commands sent, seconds]
    last = {"t": None, "done": None, "sent": 0}

    def observe(now: float) -> None:
        lc = drv.last_committed
        sent = N * cmds * sent_steps[0]
        if lc is not None:
            done = int(lc.astype(np.int64).sum())
            if last["done"] is not None:
                acc = rate_by_k.setdefault(cur, [0, 0, 0.0])
                acc[0] += done - last["done"]
                acc[1] += sent - last["sent"]
                acc[2] += now - last["t"]
            last["done"] = done
        last["t"], last["sent"] = now, sent
        obs.snapshot()
        d = tuner.tick()
        if d is not None:
            decisions.append({k: d[k] for k in ("knob", "old", "new",
                                                "phase", "objective",
                                                "tick")})
            if d["knob"] == "superstep_k":
                decided.add(d["new"])
        want = tuner.knobs["wal_max_batch_interval_ms"]
        have = [w.max_batch_interval_ms for w in eng._dur.wals]
        if any(v != want for v in have):
            raise AssertionError(f"tune_path: shard intervals {have} != "
                                 f"the knob {want}")

    t0 = time.perf_counter()
    t_obs = t0
    while time.perf_counter() - t0 < seconds:
        if tuner.knobs["superstep_k"] != cur:
            # the restage between dispatches; the first window at the
            # new K holds its capture, so its rate is not kept
            cur = tuner.knobs["superstep_k"]
            nb, pb = blocks(cur)
            last["done"] = None
        submit()
        now = time.perf_counter()
        if now - t_obs >= 0.2:
            t_obs = now
            observe(now)
    tuned_s = time.perf_counter() - t0
    shares = phase_shares(obs.window_rates())
    verdicts = {name: o["verdict"]
                for name, o in slo.evaluate()["objectives"].items()}
    # let a capture freeze run out and take one tick, so that the probe
    # below starts from an unfrozen tuner (a freeze is recorded when it
    # begins)
    time.sleep(max(0.0, tuner._compile_quiet_until - time.time()) + 0.05)
    observe(time.perf_counter())
    # a K decided by the window's last tick or by the one just taken has
    # not been dispatched yet: restage it and dispatch until its first
    # block has gone out, so that every decision is held to its stamp
    if tuner.knobs["superstep_k"] != cur:
        cur = tuner.knobs["superstep_k"]
        nb, pb = blocks(cur)
        last["done"] = None
    while dispatched[-1]["k"] != cur:
        submit()
    # two ticks under an installed DiskFaultPlan (a quiet one: no fault
    # is injected, being installed is what freezes)
    f0 = sum(1 for e in RECORDER.events("tune") if e[1] == "tune.freeze")
    d0 = len(tuner.decisions)
    faults.install_plan(faults.DiskFaultPlan(seed=1))
    try:
        frozen = []
        for _ in range(2):
            submit()
            obs.snapshot()
            frozen.append(tuner.tick())
            frozen.append(tuner.overview()["freeze_reason"])
    finally:
        faults.clear_plan()
    freezes = sum(1 for e in RECORDER.events("tune")
                  if e[1] == "tune.freeze") - f0
    if frozen != [None, "disk_fault_plan_active"] * 2 or freezes != 1 or \
            len(tuner.decisions) != d0:
        raise AssertionError(f"tune_path: under a DiskFaultPlan {frozen}, "
                             f"{freezes} freezes")
    drv.drain()
    k, staged[0] = staged[0], None
    sent_steps[0] += k
    prof_out = {}
    if profile_dir is not None:
        torch.cuda.synchronize()
        s0 = sent_steps[0]
        with trace.torch_profile(profile_dir) as prof:
            t1 = time.perf_counter()
            for _ in range(3):
                submit()
            drv.drain()
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t1
        k, staged[0] = staged[0], None
        sent_steps[0] += k
        sums = device_sums(prof)
        busy_ms = sums["kernels"] + sums["copies"]
        prof_out = {"profiled_k": cur, "profiled_dispatches": 3,
                    "profiled_inner_steps": sent_steps[0] - s0,
                    "traced_s": traced_s, "device_busy_ms": busy_ms,
                    "device_idle_share": 1.0 - busy_ms / (traced_s * 1e3),
                    "commit_phase_executions": sums["executions"]}
    eng._dur.flush_all()
    settle_steps = settle_durable(eng, cmds)
    sampler.drain()
    prom = prometheus_round_trip(obs, parse_prometheus)
    # exact: the leaders' logs, the WAL's accepted rows and every member's
    # counter all equal the committed total
    lane = np.arange(N)
    st = eng.state
    lead = st.leader_slot.cpu().numpy()
    per_lane = eng.committed_per_lane().astype(np.int64)
    tail = st.last_index.cpu().numpy()[lane, lead].astype(np.int64)
    counter = eng.machine_states()
    committed = int(per_lane.sum())
    ctr, steps = eng._dur.counters, eng._dur.step_seq
    wal_rows = (ctr["readback_bytes"] - steps * (16 * N + 4 * (shards - 1))) \
        // 4
    sent = N * cmds * sent_steps[0]
    if not (per_lane == tail).all() or not \
            (counter == per_lane[:, None]).all() or wal_rows != committed \
            or committed > sent:
        raise AssertionError(f"tune_path: committed {committed}, WAL rows "
                             f"{wal_rows}, sent {sent}")
    rates = {k: {"committed_cmds_per_s": v[0] / v[2],
                 "sent_cmds_per_s": v[1] / v[2], "seconds": v[2]}
             for k, v in rate_by_k.items() if v[2] > 0}
    out = {"lanes": N, "members": P, "cmds_per_step": cmds,
           "wal_shards": shards, "sync_mode": 1, "max_pending": max(8, 4 * k0),
           "tuner": {"cooldown_windows": 1, "breach_windows": 1,
                     "incident_freeze_s": 0.0, "compile_freeze_s": 1.0,
                     "bounds": tuner.bounds, "tick_s": 0.2},
           "tuned_s": tuned_s, "decisions": decisions,
           "ticks": tuner.ticks, "freezes": tuner.freezes,
           "converged_k": cur, "k_dispatched": dispatched,
           "rates_by_k": rates, "captures": captures,
           "last_window_phase_shares": shares, "slo_verdicts": verdicts,
           "disk_fault_freeze": {"ticks": 2, "freeze_events": freezes,
                                 "decisions": 0},
           "frozen_ticks": 2, "inner_steps_sent": sent_steps[0],
           "settle_steps": settle_steps, "sent_cmds": sent,
           "committed": committed, "accepted_share": committed / sent,
           "committed_exact": True, "committed_equals_sent":
           committed == sent, "prometheus_round_trip": prom,
           "autotune": tuner.overview(), **prof_out}
    obs.close()
    eng.close()
    shutil.rmtree(wal_dir, ignore_errors=True)
    return out


def phase_tune_path(dev, seconds: float = 30.0, k_hi: int = 64) -> dict:
    """``tune_loop`` at full width: 10,000 x 5, 128 commands a lane a
    step, its WAL under build/; the launches of every kernel counted from
    0 just before."""
    mods = kernel_modules(zero=True)
    t0 = time.perf_counter()
    out = tune_loop(dev, str(WAL_ROOT / "tune"), seconds=seconds, k_hi=k_hi,
                    profile_dir=str(WAL_ROOT / "tune_profile"))
    launches = used_only("tune_path", mods, "commit_phase")
    emit({"phase": "tune_path", "seconds": time.perf_counter() - t0,
          "host_launches": launches, **out})
    return launches


def wal_logs(data_dir: str, scan, decode, n_lanes: int) -> list:
    """Every lane's log rebuilt from the engine WAL records under
    ``data_dir`` (steps in order, a lane slice a shard): a list of
    ``[n_entries, C]`` arrays, a noop an all-zero row.  No record may
    truncate (the paths hold no election)."""
    steps: dict = {}
    for root, _dirs, names in os.walk(data_dir):
        tables: dict = {}
        for name in sorted(n for n in names if n.endswith(".wal")):
            scan(os.path.join(root, name), tables)
        for s, (_term, blk) in tables.get("__engine__", {}).items():
            steps.setdefault(s, []).append(decode(blk))
    logs: list = [[] for _ in range(n_lanes)]
    tails = np.zeros(n_lanes, np.int64)
    for s in sorted(steps):
        for lane_lo, hi, n_app, _n_acc, rows in steps[s]:
            for i in np.nonzero(n_app)[0]:
                lane = lane_lo + int(i)
                if int(hi[i]) - int(n_app[i]) != tails[lane]:
                    raise AssertionError(f"WAL step {s} lane {lane} "
                                         "truncates its log")
                logs[lane].append(rows[i, :n_app[i]])
                tails[lane] = hi[i]
    c = next((b.shape[1] for lg in logs for b in lg), 1)
    return [np.concatenate(lg) if lg else np.zeros((0, c), np.int32)
            for lg in logs]


def graph_keys(eng) -> list:
    """The shape keys of an engine's captured graphs (none on the CPU)."""
    return [] if eng._graphs is None else list(eng._graphs._graphs)


def reads_loop(dev, wal_dir: str, *, lanes: int = 1024, members: int = 3,
               seconds: float = 3.0, read_share: float = 0.9, kr: int = 16,
               cmds: int = 8, superstep_k: int = 4, seed: int = 0) -> dict:
    """``bench.py --reads`` at its defaults on the port: ``JitKvMachine(64)``,
    ``lanes`` x ``members``, durable with 2 WAL shards, K = 4, 8 commands
    and 16 reads a lane, lease TTL 8, read share 0.9, 2 x lanes rows a
    wave over 4,096 sessions through the ingress plane (puts and gets in
    the same dispatches), ``seconds`` per measured section: the per-call
    ``consistent_read`` baseline, a write-only section at half the time,
    the mixed run.  The SLO engine stamps verdicts only (not wired into
    the ladder, as in ``bench.py``).

    Held: no graph capture over the measured sections; every replica's
    final KV state equals a plain model of the puts in commit order (the
    lanes' logs rebuilt from the WAL, whose puts are the accepted puts in
    submission order); every served read returns the newest put to its
    key at or below its watermark."""
    from ra_tpu_torch.devicewatch import WATCH
    from ra_tpu_torch.engine.durable import decode_block, open_engine
    from ra_tpu_torch.ingress import IngressPlane
    from ra_tpu_torch.log.wal import scan_wal_file
    from ra_tpu_torch.models import JitKvMachine
    from ra_tpu_torch.slo import SloEngine
    from ra_tpu_torch.telemetry import Observatory
    wave_rows = 2 * lanes
    n_w = max(1, int(round(wave_rows * (1.0 - read_share))))
    n_r = max(1, wave_rows - n_w)
    n_keys = 64
    rng = np.random.default_rng(seed)
    shutil.rmtree(wal_dir, ignore_errors=True)
    eng = open_engine(JitKvMachine(n_keys=n_keys), wal_dir, lanes, members,
                      wal_shards=2,
                      ring_capacity=max(64, superstep_k * cmds * 4),
                      max_step_cmds=cmds, max_step_reads=kr, lease_ttl=8,
                      device=dev)
    plane = IngressPlane(eng, superstep_k=superstep_k, window_s=0.001,
                         soft_credit=1 << 20, hard_credit=1 << 20)
    obs = Observatory.for_engine(eng)
    slo = SloEngine(obs)
    sess = plane.directory.connect_bulk(4096, key="bench-reads")
    lane_of = plane.directory.lane
    write_waves: collections.deque = collections.deque()
    write_lats: list = []
    released = [0]

    def on_commit(handles) -> None:
        released[0] += len(handles)
        t = time.perf_counter()
        while write_waves and write_waves[0][0] <= released[0]:
            write_lats.append(t - write_waves.popleft()[1])

    plane.on_block_committed = on_commit
    stride = 1 << 20
    wave_t = np.zeros(1 << 16, np.float64)
    wave_keys: list = []
    read_lats: list = []
    served: list = []           # (lane, key, watermark, reply) per served read

    def on_reads(handles, seqnos, statuses, wms, payloads) -> None:
        now = time.perf_counter()
        ok = np.asarray(statuses) == 0
        if ok.any():
            s = np.asarray(seqnos)[ok]
            w, i = s // stride, s % stride
            read_lats.extend((now - wave_t[w]).tolist())
            keys = np.empty(len(s), np.int64)
            for wv in np.unique(w):
                at = w == wv
                keys[at] = wave_keys[wv][i[at]]
            served.append((lane_of[np.asarray(handles)[ok]], keys,
                           np.asarray(wms)[ok], np.asarray(payloads)[ok]))

    plane.on_reads_done = on_reads
    puts: list = []             # (lanes, payload rows) of accepted puts
    wave_idx = [0]
    last_snap = [0.0]

    def wave(do_reads: bool) -> None:
        wh = sess[rng.choice(len(sess), size=n_w, replace=False)]
        pay = np.zeros((n_w, 4), np.int32)
        pay[:, 0] = 1
        pay[:, 1] = rng.integers(0, n_keys, n_w)
        pay[:, 2] = rng.integers(0, 1 << 20, n_w)
        st = plane.submit_auto(wh, pay)
        ok = st <= 1
        puts.append((lane_of[wh[ok]], pay[ok]))
        write_waves.append((plane.counters["accepted"], time.perf_counter()))
        if do_reads:
            rh = sess[rng.choice(len(sess), size=n_r, replace=False)]
            q = np.zeros((n_r, 2), np.int32)
            q[:, 0] = 1
            q[:, 1] = rng.integers(0, n_keys, n_r)
            wave_keys.append(q[:, 1])
            wave_t[wave_idx[0]] = time.perf_counter()
            plane.submit_reads(rh, wave_idx[0] * stride + np.arange(n_r), q)
        else:
            wave_keys.append(None)
        wave_idx[0] += 1
        plane.pump(force=True)
        now = time.perf_counter()
        if now - last_snap[0] > 0.1:
            last_snap[0] = now
            obs.snapshot()

    # warm-up as bench.py's, plus one write-only wave with no read
    # pending: on the card a dispatch without a read schedule is a graph
    # of its own (the reference runs both through one executable)
    for _ in range(3):
        wave(True)
    plane.settle(timeout=120.0)
    wave(False)
    plane.settle(timeout=120.0)
    eng.consistent_read([0])
    n_calls = 5
    t0 = time.perf_counter()
    for i in range(n_calls):
        eng.consistent_read([i % lanes])
    percall_s = (time.perf_counter() - t0) / n_calls
    eng.phases.reset_reservoirs()
    write_lats.clear()
    read_lats.clear()
    dw0 = dict(WATCH.counters)
    keys0 = graph_keys(eng)
    t_w0 = time.perf_counter()
    while time.perf_counter() - t_w0 < seconds * 0.5:
        wave(False)
    plane.settle(timeout=120.0)

    def p99(xs):
        xs = sorted(xs)
        return 1000 * xs[min(len(xs) - 1, int(len(xs) * 0.99))] \
            if xs else -1.0

    write_only_p99_ms = p99(write_lats)
    eng.phases.reset_reservoirs()
    write_lats.clear()
    rc0 = dict(plane.read_counters)
    wrote0 = plane.counters["accepted"]
    t_mix = time.perf_counter()
    while time.perf_counter() - t_mix < seconds:
        wave(True)
    plane.settle(timeout=120.0)
    elapsed = time.perf_counter() - t_mix
    obs.snapshot()
    verdicts = {name: o["verdict"]
                for name, o in slo.evaluate()["objectives"].items()}
    dw = WATCH.counters
    recaptures = dw["recompiles"] - dw0["recompiles"]
    captures = dw["compiles"] - dw0["compiles"]
    rc = plane.read_counters
    served_n = rc["served"] - rc0["served"]
    blocks = max(1, rc["blocks_built"] - rc0["blocks_built"])
    read_cmds_per_s = served_n / max(elapsed, 1e-9)
    out = {"lanes": lanes, "members": members, "cmds_per_step": cmds,
           "read_window": kr, "superstep_k": superstep_k, "wal_shards": 2,
           "lease_ttl": 8, "read_share": read_share, "wave_rows": wave_rows,
           "sessions": len(sess), "seconds_per_section": seconds,
           "read_cmds_per_s": read_cmds_per_s,
           "read_p99_ms": p99(read_lats),
           "read_e2e_phase_p99_ms":
           eng.phases.overview()["read_e2e"]["p99_ms"],
           "write_cmds_per_s": (plane.counters["accepted"] - wrote0)
           / max(elapsed, 1e-9),
           "write_p99_ms": p99(write_lats),
           "write_only_p99_ms": write_only_p99_ms,
           "reads_per_dispatch": (rc["block_rows"] - rc0["block_rows"])
           / blocks,
           "read_served": served_n,
           "read_shed": rc["shed"] - rc0["shed"],
           "read_stale_refused": rc["stale_refused"] - rc0["stale_refused"],
           "percall_read_ms": 1000 * percall_s,
           "read_plane_speedup_vs_percall": read_cmds_per_s * percall_s,
           "slo": verdicts,
           "slo_read_verdict": verdicts.get("read_p99_ms", "no_data"),
           "slo_write_verdict": verdicts.get("commit_p99_ms", "no_data"),
           "steady_state_captures": captures,
           "steady_state_recaptures": recaptures}
    if recaptures or captures:
        raise AssertionError(
            f"reads_path: {captures} captures, {recaptures} re-captures in "
            f"the measured sections: graphs {keys0} -> {graph_keys(eng)}")
    # the oracle: logs from the WAL, puts in commit order
    eng._dur.flush_all()
    logs = wal_logs(wal_dir, scan_wal_file, decode_block, lanes)
    want_puts = [[] for _ in range(lanes)]
    for ls, rows in puts:
        for lane, row in zip(ls.tolist(), rows):
            want_puts[lane].append(row)
    p_lane, p_key, p_idx, p_val = [], [], [], []
    for lane, lg in enumerate(logs):
        is_put = lg[:, 0] == 1
        got = lg[is_put]
        want = np.array(want_puts[lane], np.int32).reshape(-1, 4)
        if not np.array_equal(got, want):
            raise AssertionError(f"reads_path: lane {lane}'s log holds "
                                 f"{len(got)} puts, {len(want)} accepted")
        p_lane.append(np.full(len(got), lane, np.int64))
        p_key.append(got[:, 1].astype(np.int64))
        p_idx.append(np.nonzero(is_put)[0] + 1)  # log indices from 1
        p_val.append(got[:, 2])
    # puts by (lane, key) cell, in log order within a cell
    cell = np.concatenate(p_lane) * n_keys + np.concatenate(p_key)
    order = np.lexsort((np.concatenate(p_idx), cell))
    cell = cell[order]
    pk = cell * (1 << 32) + np.concatenate(p_idx)[order]
    pv = np.concatenate(p_val)[order]
    # the plain model: each cell ends at its last put
    model = np.full(lanes * n_keys, -1, np.int64)
    last = np.r_[cell[1:] != cell[:-1], True] if len(cell) else cell
    model[cell[last]] = pv[last]
    states = eng.machine_states()                # [N, P, n_keys]
    if not (states == model.reshape(lanes, 1, n_keys)).all():
        raise AssertionError("reads_path: a replica's KV state differs "
                             "from the model of its log's puts")
    # every served read: the newest put to its key at or below its mark
    r_lane = np.concatenate([s[0] for s in served])
    r_key = np.concatenate([s[1] for s in served])
    r_wm = np.concatenate([s[2] for s in served]).astype(np.int64)
    r_pay = np.concatenate([s[3] for s in served])
    r_cell = r_lane * n_keys + r_key
    at = np.searchsorted(pk, r_cell * (1 << 32) + r_wm, side="right") - 1
    hit = (at >= 0) & (pk[np.maximum(at, 0)] >> 32 == r_cell)
    want_val = np.where(hit, pv[np.maximum(at, 0)], -1)
    want_pay = np.stack([(want_val >= 0).astype(np.int32),
                         want_val.astype(np.int32)], -1)
    if (r_wm < 0).any() or not np.array_equal(r_pay, want_pay):
        bad = int((r_pay != want_pay).any(-1).sum())
        raise AssertionError(f"reads_path: {bad} of {len(r_pay)} served "
                             "reads differ from the log at their mark")
    out.update({"oracle_reads_checked": int(len(r_pay)),
                "oracle_puts": int(sum(len(w) for w in want_puts)),
                "kv_state_equal_model": True,
                "reads_equal_log_at_watermark": True})
    obs.close()
    eng.close()
    shutil.rmtree(wal_dir, ignore_errors=True)
    return out


def phase_reads_path(dev) -> dict:
    """``reads_loop`` at ``bench.py --reads``' defaults, its WAL under
    build/; the launches of every kernel counted from 0 just before."""
    mods = kernel_modules(zero=True)
    t0 = time.perf_counter()
    out = reads_loop(dev, str(WAL_ROOT / "reads"))
    launches = used_only("reads_path", mods, "commit_phase", "slot_fold")
    emit({"phase": "reads_path", "seconds": time.perf_counter() - t0,
          "host_launches": launches, **out})
    return launches


# -- the lane mesh -------------------------------------------------------------

def mesh_layouts(dev) -> list:
    """``(where, four slots)``: four slots on one card, and one slot a
    card in turn where the machine has two cards or more."""
    count = torch.cuda.device_count()
    out = [("one_card", [dev] * 4)]
    if count >= 2:
        out.append(("cards", [torch.device("cuda", i % count)
                              for i in range(4)]))
    return out


def mesh_equal(a, b, aux_a, aux_b, state_to_numpy, what: str) -> None:
    """The sharded engine ``b`` equal to ``a`` on every leaf and dtype,
    and its stacked committed watermark equal to ``a``'s."""
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    bad = [k for k in sa if sa[k].dtype != sb[k].dtype
           or not np.array_equal(sa[k], sb[k])]
    if set(sa) != set(sb) or bad:
        raise AssertionError(f"{what}: leaves differ {bad[:4]}")
    if aux_a is not None and not np.array_equal(
            aux_a["committed_lanes"].cpu().numpy(),
            np.asarray(aux_b["committed_lanes"])):
        raise AssertionError(f"{what}: committed watermarks differ")


def phase_mesh_parity(LockstepEngine, state_to_numpy, dev) -> dict:
    """The counter and ``JitKvMachine(16)`` sharded over a 1x4 mesh (3
    members) and a 2x2 mesh (4 members, the members axis split) of four
    slots on one card, and over one slot a card where there are two cards
    or more: 1,024 lanes, 8 commands, K = 1 then 8, three dispatches each
    with a mid-dispatch election on a failed leader, then four distinct
    blocks through mesh_superstep_driver (the host running ahead); after every dispatch every leaf (and
    the stacked committed watermark) equal to an unsharded card engine
    fed the same blocks.  Kernel launches counted from 0 just before."""
    from ra_tpu_torch.models import CounterMachine, JitKvMachine
    from ra_tpu_torch.parallel.mesh import (lane_mesh,
                                            mesh_superstep_driver,
                                            shard_engine_state)
    mods = kernel_modules(zero=True)
    t0 = time.perf_counter()
    N, kc = 1024, 8
    rows = []
    for where, slots in mesh_layouts(dev):
        for m_ax, P in ((1, 3), (2, 4)):
            for name, make in (("sequential", CounterMachine),
                               ("kv", lambda: JitKvMachine(16))):
                def mk():
                    return LockstepEngine(make(), N, P, ring_capacity=64,
                                          max_step_cmds=kc,
                                          apply_window=kc + 2, device=dev)
                a, b = mk(), mk()
                mesh = lane_mesh(slots, member_axis=m_ax)
                shard_engine_state(b, mesh)
                rng = np.random.default_rng(10 * m_ax + len(name))
                what = f"mesh_parity {where} {b.mesh_shape()} {name}"
                checks = 0
                for k in (1, 8):
                    failed = []
                    for rnd in range(3):
                        n_new = rng.integers(0, kc + 1, (k, N)) \
                            .astype(np.int32)
                        pay = parity_payloads(name, rng, k, N, kc)
                        elect = np.zeros((k, N), bool)
                        if rnd == 1:
                            lead = int(a.state.leader_slot[1])
                            a.fail_member(1, lead)
                            b.fail_member(1, lead)
                            failed.append((1, lead))
                            elect[min(1, k - 1), 1] = True
                        aux_a = a.superstep(n_new, pay, elect_blk=elect)
                        aux_b = b.superstep(n_new, pay, elect_blk=elect)
                        mesh_equal(a, b, aux_a, aux_b, state_to_numpy,
                                   f"{what} K={k} r={rnd}")
                        checks += 1
                    for lane, slot in failed:
                        if int(a.state.leader_slot[lane]) != slot:
                            a.recover_member(lane, slot)
                            b.recover_member(lane, slot)
                    drv = mesh_superstep_driver(b, mesh)
                    for _ in range(4):
                        nb = rng.integers(0, kc + 1, (k, N)).astype(np.int32)
                        pb = parity_payloads(name, rng, k, N, kc)
                        a.superstep(nb, pb)
                        drv.submit(nb, pb)
                    drv.close()
                    mesh_equal(a, b, None, None, state_to_numpy,
                               f"{what} K={k} driver")
                    checks += 1
                rows.append({"where": where, "mesh": b.mesh_shape(),
                             "members": P, "machine": type(a.machine)
                             .__name__, "checks": checks,
                             "devices": [str(d) for d in
                                         mesh.distinct_devices()]})
    launches = used_only("mesh_parity", mods, "commit_phase", "slot_fold")
    emit({"phase": "mesh_parity", "seconds": time.perf_counter() - t0,
          "lanes": N, "cmds_per_step": kc, "superstep_k": [1, 8],
          "runs": rows, "states_equal": True, "host_launches": launches})
    return launches


def shard_spans(fn):
    """Run ``fn()`` with a fresh tracer on; returns (fn's result, the
    host ms of each ``engine.shard`` span, by shard)."""
    from ra_tpu_torch import trace
    tracer = trace.Tracer()
    trace.set_tracer(tracer)
    try:
        out = fn()
    finally:
        trace.set_tracer(None)
    by: dict = collections.defaultdict(list)
    for e in tracer.events():
        if e.get("name") == "engine.shard":
            by[e["args"]["shard"]].append(e["dur"] / 1e3)
    return out, {j: {"count": len(v), "p50_ms": sorted(v)[len(v) // 2],
                     "max_ms": max(v)} for j, v in sorted(by.items())}


def member_copy_ms(eng, reps: int = 20) -> dict:
    """Device ms a dispatch of the members axis' gather and scatter (every
    lane shard's), by CUDA events on one card; 0 copies on a lanes-only
    mesh."""
    shards = eng._shards
    if not any(sh.split for sh in shards):
        return {"gather_ms": 0.0, "scatter_ms": 0.0, "copy_bytes": 0}
    fulls = [sh.gather() for sh in shards]
    torch.cuda.synchronize()

    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    gather = timed(lambda: [sh.gather() for sh in shards])
    scatter = timed(lambda: [sh.scatter(f) for sh, f in zip(shards, fulls)])
    eng._state_joined = None
    return {"gather_ms": gather, "scatter_ms": scatter,
            "copy_bytes": sum(sh.copy_bytes for sh in shards)}


def mesh_counter_window(dev, m_ax: int, P: int, *, N: int = 10_000,
                        cmds: int = 128, K: int = 8, warm: int = 2,
                        timed: int = 25) -> dict:
    """BASELINE's counter at N x P, 128 commands a lane a step, through
    mesh_superstep_driver over a ``m_ax`` x (4 / m_ax) mesh of four slots
    on one card: ms per inner step, committed cmds/s, the host graph call
    p50 of each shard, the members axis' copy ms a dispatch; exact
    commits and counters after a settling block."""
    from ra_tpu_torch.devicewatch import WATCH
    from ra_tpu_torch.engine import LockstepEngine
    from ra_tpu_torch.models import CounterMachine
    from ra_tpu_torch.parallel.mesh import (lane_mesh,
                                            mesh_superstep_driver,
                                            shard_engine_state)
    eng = LockstepEngine(CounterMachine(), N, P, ring_capacity=1024,
                         max_step_cmds=cmds, apply_window=cmds + 2,
                         write_delay=1, device=dev)
    mesh = shard_engine_state(eng, lane_mesh([dev] * 4, member_axis=m_ax))
    drv = mesh_superstep_driver(eng, mesh)
    n_blk, p_blk = counter_blocks(N, cmds, K)
    for _ in range(warm):
        drv.submit(n_blk, p_blk)
    drv.drain()
    torch.cuda.synchronize()
    watch0 = dict(WATCH.counters)
    committed0 = eng.committed_total()

    def window():
        t0 = time.perf_counter()
        for _ in range(timed):
            drv.submit(n_blk, p_blk)
        drv.drain()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    seconds, spans = shard_spans(window)
    committed1 = eng.committed_total()
    captures = WATCH.counters["compiles"] - watch0["compiles"]
    copies = member_copy_ms(eng)
    drv.submit(np.zeros((K, N), np.int32), p_blk)
    drv.close()
    want = cmds * K * (warm + timed)
    per_lane = eng.committed_per_lane()
    counters = eng.machine_states()
    if captures or not (per_lane == want).all() or \
            not (counters == want).all():
        raise AssertionError(f"mesh {eng.mesh_shape()}: {captures} "
                             "captures in the window, or committed != "
                             f"{want} on {int((per_lane != want).sum())} "
                             "lanes")
    return {"mesh": eng.mesh_shape(), "lanes": N, "members": P,
            "superstep_k": K, "cmds_per_step": cmds,
            "timed_dispatches": timed, "slots_on": str(dev),
            "ms_per_inner_step": seconds / (timed * K) * 1e3,
            "committed_cmds_per_s": (committed1 - committed0) / seconds,
            "host_graph_call_by_shard": spans,
            "member_copy_ms_per_dispatch": copies["gather_ms"]
            + copies["scatter_ms"], "member_gather_ms": copies["gather_ms"],
            "member_scatter_ms": copies["scatter_ms"],
            "member_copy_bytes_per_dispatch": copies["copy_bytes"],
            "input_copies_between_devices": 0,
            "committed_per_lane": want, "counters_equal": True}


def mesh_rung_point(dev, m_ax: int, lanes: int, members: int, *,
                    cmds: int = 8, seconds: float = 2.0) -> dict:
    """One point of ``bench.py --multichip``'s sweep on four slots of one
    card: the counter at ``lanes`` x ``members``, ``cmds`` commands,
    write delay 1, through mesh_superstep_driver with a sampler at every
    inner step, an Observatory, an SloEngine with a throughput floor past
    reach and an AutoTuner walking K from 1 (to 32, 16 or 8 by lanes, as
    the bench bounds it) for ``seconds``; the realized rate at each K and
    over the window.  Held against a plain model of the mix: after drain
    and two empty steps every lane committed and applied ``cmds`` times
    its inner steps."""
    from ra_tpu_torch.autotune import AutoTuner
    from ra_tpu_torch.engine import LockstepEngine
    from ra_tpu_torch.models import CounterMachine
    from ra_tpu_torch.parallel.mesh import (drive_uniform_window, lane_mesh,
                                            mesh_superstep_driver,
                                            shard_engine_state)
    from ra_tpu_torch.slo import SloEngine, default_objectives
    from ra_tpu_torch.telemetry import Observatory, TelemetrySampler
    eng = LockstepEngine(CounterMachine(), lanes, members,
                         ring_capacity=max(64, 4 * cmds), max_step_cmds=cmds,
                         apply_window=cmds + 2, write_delay=1, device=dev)
    mesh = shard_engine_state(eng, lane_mesh([dev] * 4, member_axis=m_ax))
    n_new = np.full((lanes,), cmds, np.int32)
    payloads = np.ones((lanes, cmds, 1), np.int32)
    for _ in range(3):
        eng.step(n_new, payloads)
    sent = 3
    drv = mesh_superstep_driver(eng, mesh)
    sampler = TelemetrySampler(eng, cadence_steps=1)
    obs = Observatory.for_engine(eng, sampler=sampler)
    slo = SloEngine(obs, default_objectives(min_cmds_per_s=1e12),
                    fast_windows=2, slow_windows=4, burn_fast=0.5)
    k_hi = 32 if lanes <= 1024 else (16 if lanes <= 8192 else 8)
    tuner = AutoTuner(slo, obs, bounds={"cmds_per_step": (cmds, cmds),
                                        "superstep_k": (1, k_hi)},
                      knobs={"superstep_k": 1, "cmds_per_step": cmds},
                      cooldown_windows=1, breach_windows=1,
                      incident_freeze_s=0.0, compile_freeze_s=0.2)

    def blocks(k):
        return (np.broadcast_to(n_new, (k, lanes)),
                np.broadcast_to(payloads, (k,) + payloads.shape))
    cur = [1]
    rate_by_k: dict = {}
    last = [0.0, None]
    walk = []

    def observe():
        now = time.perf_counter()
        if now - last[0] < 0.2:
            return None
        lc = drv.last_committed
        if lc is not None:
            done = int(lc.astype(np.int64).sum())
            if last[1] is not None:
                acc = rate_by_k.setdefault(cur[0], [0, 0.0])
                acc[0] += done - last[1]
                acc[1] += now - last[0]
            last[1] = done
        last[0] = now
        obs.snapshot()
        tuner.tick()
        if tuner.knobs["superstep_k"] != cur[0]:
            cur[0] = tuner.knobs["superstep_k"]
            walk.append(cur[0])
            last[1] = None          # the first window holds the capture
            return blocks(cur[0])
        return None
    nb, pb = blocks(1)
    for _ in range(2):
        drv.submit(nb, pb)
    drv.drain()
    sent += 2
    c0 = eng.committed_total()
    t0 = time.perf_counter()
    dispatches, inner, _el = drive_uniform_window(drv, nb, pb, seconds,
                                                  observe=observe)
    drv.drain()
    elapsed = time.perf_counter() - t0
    committed = eng.committed_total() - c0
    sent += inner
    drv.close()
    obs.close()
    eng._telemetry = None
    for _ in range(2):
        eng.step(np.zeros_like(n_new), payloads)
    per_lane = eng.committed_per_lane()
    counters = eng.machine_states()
    want = cmds * sent
    if not (per_lane == want).all() or not (counters == want).all():
        raise AssertionError(f"mesh rung {eng.mesh_shape()} x {lanes}: "
                             f"committed != {want} on "
                             f"{int((per_lane != want).sum())} lanes")
    return {"mesh": eng.mesh_shape(), "lanes": lanes, "members": members,
            "cmds_per_step": cmds, "seconds": seconds,
            "dispatches": dispatches, "inner_steps": inner,
            "committed_cmds_per_s": committed / elapsed,
            "k_walk": walk, "k_last": cur[0], "k_bound": k_hi,
            "rate_by_k": {k: v[0] / v[1] for k, v in rate_by_k.items()
                          if v[1] > 0},
            "committed_equals_model": True}


def mesh_durable_run(dev, wal_dir: str, state_to_numpy, *, N: int = 10_000,
                     P: int = 5, cmds: int = 16, K: int = 8,
                     dispatches: int = 10) -> dict:
    """open_engine with per_device_wal_shards (4) under a 1x4 mesh of four
    slots on one card, sync_mode 1, through mesh_superstep_driver; after
    flush and settle the committed total equals every leader's log, each
    member's counter and the lanes' logs rebuilt from the WAL (RTB2
    blocks, one WAL shard a lane shard); then a checkpoint, close, and
    open_engine (unsharded, on the card) equal on the core leaves."""
    from ra_tpu_torch.engine.durable import decode_block, open_engine
    from ra_tpu_torch.log.wal import scan_wal_file
    from ra_tpu_torch.models import CounterMachine
    from ra_tpu_torch.parallel.mesh import (lane_mesh,
                                            mesh_superstep_driver,
                                            per_device_wal_shards,
                                            shard_engine_state)
    shutil.rmtree(wal_dir, ignore_errors=True)
    mesh = lane_mesh([dev] * 4)
    shards = per_device_wal_shards(mesh)
    kw = dict(wal_shards=shards, sync_mode=1, max_pending=32,
              ring_capacity=1024, max_step_cmds=cmds,
              apply_window=cmds + 2, device=dev)
    eng = open_engine(CounterMachine(), wal_dir, N, P, **kw)
    shard_engine_state(eng, mesh)
    drv = mesh_superstep_driver(eng, mesh)
    n_blk, p_blk = counter_blocks(N, cmds, K)
    t0 = time.perf_counter()
    for _ in range(dispatches):
        drv.submit(n_blk, p_blk)
    drv.close()
    seconds = time.perf_counter() - t0
    eng._dur.flush_all()
    settle = settle_durable(eng, cmds)
    lane = np.arange(N)
    st = eng.state
    lead = st.leader_slot.cpu().numpy()
    per_lane = eng.committed_per_lane().astype(np.int64)
    tail = st.last_index.cpu().numpy()[lane, lead].astype(np.int64)
    counters = eng.machine_states()
    logs = wal_logs(wal_dir, scan_wal_file, decode_block, N)
    log_len = np.array([len(lg) for lg in logs], np.int64)
    log_sum = np.array([int(lg.astype(np.int64).sum()) for lg in logs])
    if not (per_lane == tail).all() or not (per_lane == log_len).all() or \
            not (counters == per_lane[:, None]).all() or \
            not (log_sum == per_lane).all():
        raise AssertionError("mesh durable: committed != logs")
    layout = eng._dur.shard_layout()
    before = core(eng.state, state_to_numpy)
    eng.checkpoint()
    eng.close()
    t1 = time.perf_counter()
    eng2 = open_engine(CounterMachine(), wal_dir, N, P, **kw)
    reopen_s = time.perf_counter() - t1
    after = core(eng2.state, state_to_numpy)
    eng2.close()
    bad = [k for k in before if not np.array_equal(before[k], after[k])]
    if bad:
        raise AssertionError(f"mesh durable reopen: leaves differ {bad[:4]}")
    shutil.rmtree(wal_dir, ignore_errors=True)
    return {"mesh": "1x4", "lanes": N, "members": P, "cmds_per_step": cmds,
            "superstep_k": K, "dispatches": dispatches, "seconds": seconds,
            "wal_shards": shards, "wal_shard_layout": layout,
            "settle_steps": settle, "committed": int(per_lane.sum()),
            "sent": N * cmds * K * dispatches,
            "committed_equals_logs": True, "reopen_s": reopen_s,
            "reopen_core_equal": True}


def phase_mesh_path(dev, volatile: dict, state_to_numpy) -> dict:
    """The lane mesh on the card, every kernel's launches counted from 0
    just before: BASELINE's counter through mesh_superstep_driver on a
    1x4 mesh (10,000 x 5) and a 2x2 mesh (10,000 x 4) of four slots on
    cuda:0, beside superstep_path's unsharded numbers from this run;
    bench.py --multichip's sweep (mesh_shapes(4) x
    ladder_rungs(lane_ladder()) at 8 commands, the autotuner walking K,
    2 s a point); and the durable 1x4 run."""
    from ra_tpu_torch.parallel.mesh import (ladder_rungs, lane_ladder,
                                            mesh_shapes)
    mods = kernel_modules(zero=True)
    t0 = time.perf_counter()
    windows = [mesh_counter_window(dev, 1, 5), mesh_counter_window(dev, 2, 4)]
    for w in windows:
        emit({"phase": "mesh_path_window", **w,
              "unsharded_superstep_path": volatile})
    rung = [mesh_rung_point(dev, m_ax, lanes, members)
            for m_ax, l_ax, members in mesh_shapes(4)
            for lanes in ladder_rungs(lane_ladder(), l_ax)]
    for r in rung:
        emit({"phase": "mesh_path_rung", **r})
    durable = mesh_durable_run(dev, str(WAL_ROOT / "mesh"), state_to_numpy)
    launches = used_only("mesh_path", mods, "commit_phase")
    emit({"phase": "mesh_path", "seconds": time.perf_counter() - t0,
          "durable": durable, "host_launches": launches})
    return launches


# -- the classic replicated plane (RaNode / RaSystem / api) --------------------

#: classic_path: bench_classic.py's phase A settings (the reference's
#: ra_bench parity run): 5 clients x 500 in flight, 256-byte payloads,
#: credit drawn in bursts of 64, 10 s, a release cursor every 100,000
CLASSIC_DEGREE, CLASSIC_PIPE, CLASSIC_BURST = 5, 500, 64
CLASSIC_SECONDS, CLASSIC_DATA_SIZE, CLASSIC_RELEASE = 10.0, 256, 100_000
#: the KV legs' JitKvMachine width
CLASSIC_KEYS = 64


def host_cpu_model() -> str:
    """The host CPU's model name (``lscpu``, else ``/proc/cpuinfo``), with
    its architecture."""
    import platform
    name = ""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
        name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                     if ln.startswith("Model name")), "")
    except (OSError, subprocess.SubprocessError):
        pass
    if not name:
        try:
            with open("/proc/cpuinfo") as f:
                info = dict(ln.split(":", 1) for ln in f if ":" in ln)
            info = {k.strip(): v.strip() for k, v in info.items()}
            name = info.get("model name") or " ".join(
                f"{k} {info[k]}" for k in ("vendor_id", "cpu family",
                                           "model", "stepping")
                if k in info)
        except OSError:
            pass
    return f"{name or 'unknown'} ({platform.machine()})"


def snapshotting(cls, every: int, **kw):
    """A factory of ``cls(**kw)`` that also releases its log every
    ``every`` indexes, so a snapshot of the card-held state lands on
    disk (a JitMachine emits no release cursor of its own)."""
    from ra_tpu_torch.core.types import ReleaseCursor

    class Snapshotting(cls):
        def apply(self, meta, command, state):
            new, reply = super().apply(meta, command, state)
            if meta.index % every == 0:
                return new, reply, [ReleaseCursor(meta.index, new)]
            return new, reply
    return lambda: Snapshotting(**kw)


def classic_scripts(n: int, seed: int) -> dict:
    """One seeded script of ``n`` commands per machine of classic_parity:
    every op of each vocabulary, misses, out-of-range and refused ones."""
    rng = np.random.default_rng(seed)
    regs, kv, fifo = [], [], []
    for _ in range(n):
        op, a, b, c = (int(x) for x in rng.integers(0, 9, 4))
        regs.append([("put", a, b * 7 - 20), ("add", a, b - 4),
                     ("cas", a, b, c)][op % 3])
        kv.append([("put", a * 2, b), ("get", a * 2), ("delete", a * 2),
                   ("cas", a * 2, b, c), ("put", a * 2, None)][op % 5]
                  if op < 8 else ("get", 99))
        fifo.append([("enqueue", a * 10 + b), ("enqueue", b),
                     ("dequeue", "settled"), ("dequeue", "unsettled"),
                     ("settle", int(rng.integers(0, n // 4))),
                     ("enqueue", c)][op % 6])
    return {"registers": regs, "jit_kv": kv, "jit_fifo": fifo}


def host_tree(st):
    if isinstance(st, dict):
        return {k: host_tree(v) for k, v in sorted(st.items())}
    return (str(st.dtype), st.device.type, st.cpu().tolist())


def pipelined(ra, leader, router, cmds: list, burst: int = 64) -> list:
    """Every command of ``cmds`` through pipeline_commands in bursts, one
    burst in flight: the replies in command order."""
    replies: dict = {}
    done = threading.Event()
    lock = threading.Lock()

    def on_notify(batch):
        with lock:
            for corr, reply in batch:
                replies[corr] = reply
            if len(replies) >= want[0]:
                done.set()
    want = [0]
    for lo in range(0, len(cmds), burst):
        chunk = cmds[lo:lo + burst]
        with lock:
            want[0] = lo + len(chunk)
            done.clear()
            if len(replies) >= want[0]:
                done.set()
        ra.pipeline_commands(leader, [(c, lo + i) for i, c in
                                      enumerate(chunk)],
                             notify_to=on_notify, router=router)
        if not done.wait(60):
            raise AssertionError(f"burst at {lo}: {len(replies)} replies")
    return [replies[i] for i in range(len(cmds))]


def co_hosted(data_dir: str, device, factory, name: str,
              election_timeout_ms: int = 5000, **cfg):
    """One RaNode over one RaSystem hosting a cluster of three members:
    (system, node, router, server ids, leader)."""
    import ra_tpu_torch as ra
    from ra_tpu_torch.core.types import ServerId
    router = ra.LocalRouter()
    system = ra.RaSystem(data_dir)
    node = ra.RaNode("cn", router=router, system=system, device=device)
    sids = [ServerId(f"{name}{i}", "cn") for i in (1, 2, 3)]
    ra.start_cluster(name, factory, sids, router=router,
                     election_timeout_ms=election_timeout_ms, **cfg)
    ra.trigger_election(sids[0], router)
    return system, node, router, sids, await_classic_leader(node, sids)


def await_classic_leader(node, sids, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for sid in sids:
            shell = node.shells.get(sid.name)
            if shell and shell.server.raft_state.value == "leader":
                return sid
        time.sleep(0.01)
    raise AssertionError("no classic leader elected")


def settle_members(node, sids, timeout: float = 60.0) -> int:
    """Wait until every member applied the leader's commit index."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        srvs = [node.shells[s.name].server for s in sids]
        commit = max(s.commit_index for s in srvs)
        if all(s.last_applied == commit for s in srvs):
            return commit
        time.sleep(0.01)
    raise AssertionError("classic members did not converge")


def classic_run_parity(name: str, factory, cmds: list, device,
                       data_dir: str, reopen: bool) -> dict:
    """The script on a co-hosted cluster; with ``reopen`` the node and
    system are closed after it and the members recovered from disk."""
    import ra_tpu_torch as ra
    system, node, router, sids, leader = co_hosted(
        data_dir, device, factory, f"p{name}")
    try:
        t0 = time.perf_counter()
        replies = pipelined(ra, leader, router, cmds)
        secs = time.perf_counter() - t0
        commit = settle_members(node, sids)
        srvs = [node.shells[s.name].server for s in sids]
        states = [host_tree(s.machine_state) for s in srvs]
        snaps = [s.log.snapshot_index_term().index for s in srvs]
    finally:
        node.stop()
        system.close()
    out = {"replies": replies, "states": states, "seconds": secs,
           "commit": commit, "snapshot_index": snaps}
    if reopen:
        system = ra.RaSystem(data_dir)
        node = ra.RaNode("cn", router=ra.LocalRouter(), system=system,
                         device=device)
        try:
            got = system.recover_servers(node, lambda c, s: factory())
            assert sorted(s.name for s in got) == \
                sorted(s.name for s in sids), got
            ra.trigger_election(sids[0], node.router)
            await_classic_leader(node, sids)
            settle_members(node, sids)
            out["recovered"] = [
                host_tree(node.shells[s.name].server.machine_state)
                for s in sids]
        finally:
            node.stop()
            system.close()
    return out


def host_apply_ms(factory, cmd, device, reps: int = 300) -> float:
    """Host clock per JitMachine.apply on ``device`` (the classic path's
    per-command cost: a few small launches and the reply's sync)."""
    from ra_tpu_torch.core.machine import ApplyMeta
    m = factory()
    st = m.init({"device": device})
    for i in range(20):
        st, _ = m.apply(ApplyMeta(i + 1, 1), cmd, st)
    t0 = time.perf_counter()
    for i in range(reps):
        st, _ = m.apply(ApplyMeta(i + 21, 1), cmd, st)
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_classic_parity(dev) -> dict:
    """RegisterMachine, JitKvMachine and JitFifoMachine(capacity=16) on
    the classic plane: three members co-hosted on one RaNode over one
    RaSystem (on build/'s disk), the machines' state on the card, one
    seeded script of 2,000 commands each; every reply and member state
    equal to the same script run by the port on the CPU; a snapshot
    (release cursor every 500), then stop, recover on the card and every
    state equal again, on the card."""
    from ra_tpu_torch.models import JitFifoMachine, JitKvMachine, \
        RegisterMachine
    mods = kernel_modules(zero=True)
    t0 = time.perf_counter()
    n = 2000
    scripts = classic_scripts(n, seed=10)
    machines = {
        "registers": (RegisterMachine, dict(n_slots=8), ("add", 3, 1)),
        "jit_kv": (JitKvMachine, dict(n_keys=16), ("put", 3, 7)),
        "jit_fifo": (JitFifoMachine, dict(capacity=16), ("enqueue", 5)),
    }
    rows = []
    for name, (cls, kw, probe_cmd) in machines.items():
        factory = snapshotting(cls, 500, **kw)
        card = classic_run_parity(name, factory, scripts[name], dev,
                                  str(WAL_ROOT / "classic" / f"{name}_card"),
                                  reopen=True)
        cpu = classic_run_parity(name, factory, scripts[name], "cpu",
                                 str(WAL_ROOT / "classic" / f"{name}_cpu"),
                                 reopen=False)
        if card["replies"] != cpu["replies"]:
            bad = next(i for i, (a, b) in enumerate(
                zip(card["replies"], cpu["replies"])) if a != b)
            raise AssertionError(f"classic_parity {name}: reply {bad} "
                                 f"{card['replies'][bad]} != "
                                 f"{cpu['replies'][bad]}")
        strip = [jsonable_state(s) for s in card["states"]]
        if strip != [jsonable_state(s) for s in cpu["states"]] or \
                len({json.dumps(s) for s in strip}) != 1:
            raise AssertionError(f"classic_parity {name}: member states "
                                 "differ from the CPU run")
        if card["recovered"] != card["states"]:
            raise AssertionError(f"classic_parity {name}: recovered states "
                                 "differ from those before the stop")
        devices = {leaf[1] for st in card["recovered"]
                   for leaf in (st.values() if isinstance(st, dict)
                                else [st])}
        if devices != {torch.device(dev).type} or \
                min(card["snapshot_index"]) <= 0:
            raise AssertionError(f"classic_parity {name}: recovered on "
                                 f"{devices}, snapshots {card['snapshot_index']}")
        rows.append({
            "machine": name, "commands": n, "commit": card["commit"],
            "snapshot_index": card["snapshot_index"],
            "card_s": card["seconds"], "cpu_s": cpu["seconds"],
            "card_cmds_per_s": n / card["seconds"],
            "cpu_cmds_per_s": n / cpu["seconds"],
            "apply_ms_card": host_apply_ms(lambda: cls(**kw), probe_cmd,
                                           dev),
            "apply_ms_cpu": host_apply_ms(lambda: cls(**kw), probe_cmd,
                                          "cpu"),
        })
    launches = {name: m.LAUNCHES for name, m in mods.items()}
    emit({"phase": "classic_parity", "seconds": time.perf_counter() - t0,
          "rows": rows, "host_launches": launches})
    return launches


def jsonable_state(st):
    """A host_tree without the device names (card and CPU compared)."""
    if isinstance(st, dict):
        return {k: jsonable_state(v) for k, v in st.items()}
    return [st[0], st[2]]


def kv_bench_cmd():
    """The KV legs' command maker: per client a seeded stream of int32
    puts (3 in 4) and gets over CLASSIC_KEYS keys."""
    rngs = {}

    def make(cid, seq):
        rng = rngs.setdefault(cid, np.random.default_rng(1000 + cid))
        k, v, op = (int(x) for x in rng.integers(
            0, [CLASSIC_KEYS, 2 ** 31 - 1, 4]))
        return ("put", k, v) if op else ("get", k)
    return make


def kv_model(commands: list) -> list:
    """The plain KV model: the last put of each key, in log order."""
    model = [-1] * CLASSIC_KEYS
    for data in commands:
        if isinstance(data, tuple) and data[0] == "put":
            model[data[1]] = data[2]
    return model


def noop_bench_machine(release: int = CLASSIC_RELEASE,
                       record: bool = False):
    """bench_classic.py's machine on the port: a count of applies, a
    release cursor every ``release`` (100,000), and the batched fold.
    With ``record`` the first 8 bytes of every command it applies (phase
    B's payloads carry their correlation there) are kept in order in
    ``applied``, outside the state."""
    from ra_tpu_torch.core.machine import Machine
    from ra_tpu_torch.core.types import ReleaseCursor

    class NoopBench(Machine):
        applied = bytearray() if record else None

        def init(self, config):
            return 0

        def apply(self, meta, command, state):
            if self.applied is not None:
                self.applied += command[:8]
            new = state + 1
            if meta.index % release == 0:
                return new, new, [ReleaseCursor(meta.index, new)]
            return new, new

        def apply_batch(self, meta, commands, state):
            if self.applied is not None:
                self.applied += b"".join(c[:8] for c in commands)
            n = len(commands)
            new = state + n
            replies = list(range(state + 1, new + 1))
            base = meta.index
            k = ((base + n - 1) // release) * release
            if k >= base:
                return new, replies, [ReleaseCursor(k, state + k - base + 1)]
            return new, replies

    return NoopBench()


class ClassicClient:
    """bench_classic.py's pipelining client: up to ``pipe`` commands in
    flight, credit drawn in bursts, enqueue -> applied latency sampled
    1 in 16; every acknowledged correlation kept (the once-only check).
    With ``reset_after_s`` (phase B's client) a window starved that long
    with no acknowledgement refills and counts a credit reset: pipelined
    casts are fire and forget, so a frame lost to a leader change loses
    its acks."""

    def __init__(self, cid: int, pipe: int, make_cmd,
                 reset_after_s: float = None):
        self.cid, self.pipe, self.credit = cid, pipe, pipe
        self.make_cmd, self.reset_after_s = make_cmd, reset_after_s
        self.acked: list = []
        self.lats: list = []
        self.inflight: dict = {}
        self.sent = self.credit_resets = 0
        self._lock = threading.Lock()
        self._have = threading.Event()

    def on_notify(self, batch) -> None:
        now = time.perf_counter()
        with self._lock:
            for corr, _reply in batch:
                self.acked.append(corr)
                t0 = self.inflight.pop(corr, None)
                if t0 is not None:
                    self.lats.append(now - t0)
            self.credit += len(batch)
        self._have.set()

    def run(self, send, stop_evt) -> None:
        seq, starved_since = 0, None
        while not stop_evt.is_set():
            with self._lock:
                take = min(self.credit, CLASSIC_BURST)
                self.credit -= take
            if take <= 0:
                self._have.clear()
                if self._have.wait(0.02) or self.reset_after_s is None:
                    starved_since = None
                    continue
                now = time.perf_counter()
                starved_since = starved_since or now
                if now - starved_since > self.reset_after_s:
                    with self._lock:
                        self.credit, starved_since = self.pipe, None
                        self.credit_resets += 1
                continue
            starved_since = None
            items = []
            t0 = time.perf_counter()
            with self._lock:
                for _ in range(take):
                    corr = (self.cid, seq)
                    if not seq & 15:
                        self.inflight[corr] = t0
                    items.append((self.make_cmd(self.cid, seq), corr))
                    seq += 1
            self.sent += take
            send(items, self.on_notify)

    def idle(self) -> bool:
        """Nothing in flight (a repeated notification returns its credit
        twice, so phase B's window can read above ``pipe``)."""
        with self._lock:
            return self.credit >= self.pipe


def run_clients(send, make_cmd, name: str,
                reset_after_s: float = None) -> dict:
    """CLASSIC_DEGREE clients x CLASSIC_PIPE through ``send`` for
    CLASSIC_SECONDS, then every acknowledgement awaited; no correlation
    acknowledged twice.  Phase B's clients (``reset_after_s``) give up on
    the acks of lost frames after a minute, and count repeated
    notifications instead of failing on them: a member that becomes
    leader notifies the entries it applies as leader, so a command
    committed before a leader change can be notified by more than one
    member (the reference does the same).  The rate counts the distinct
    acknowledgements inside the window."""
    clients = [ClassicClient(i, CLASSIC_PIPE, make_cmd, reset_after_s)
               for i in range(CLASSIC_DEGREE)]
    stop = threading.Event()
    threads = [threading.Thread(target=c.run, args=(send, stop),
                                daemon=True) for c in clients]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(CLASSIC_SECONDS)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    acked_in_window = len({corr for c in clients for corr in c.acked})
    elapsed = time.perf_counter() - t0
    deadline = time.monotonic() + 60
    while not all(c.idle() for c in clients):
        if time.monotonic() > deadline:
            if reset_after_s is not None:
                break
            raise AssertionError(f"{name}: acknowledgements missing: "
                                 f"{[c.pipe - c.credit for c in clients]}")
        time.sleep(0.01)
    acked = [corr for c in clients for corr in c.acked]
    sent = sum(c.sent for c in clients)
    distinct = len(set(acked))
    if reset_after_s is None and not len(acked) == distinct == sent:
        raise AssertionError(f"{name}: {sent} sent, {len(acked)} acked, "
                             f"{distinct} distinct")
    lats = sorted(x for c in clients for x in c.lats)
    k = len(lats)
    return {
        "committed_cmds_per_s": acked_in_window / elapsed,
        "acked": distinct, "sent": sent, "elapsed_s": elapsed,
        "repeated_notifications": len(acked) - distinct,
        "p50_applied_latency_ms": 1e3 * lats[k // 2] if k else -1.0,
        "p99_applied_latency_ms":
            1e3 * lats[min(k - 1, int(k * 0.99))] if k else -1.0,
        "latency_samples": k, "acked_corrs": set(acked),
        "credit_resets": sum(c.credit_resets for c in clients)}


def classic_drive(data_dir: str, dev, factory, make_cmd, name: str,
                  want_log: bool) -> tuple:
    """One bench_classic phase A run on the port: the clients for
    CLASSIC_SECONDS, every acknowledgement awaited, the members settled;
    then close, reopen and recover: (row, member states, recovered
    states, the committed log when ``want_log``)."""
    import ra_tpu_torch as ra
    system, node, router, sids, leader = co_hosted(
        data_dir, dev, factory, name, election_timeout_ms=500,
        tick_interval_ms=100)
    try:
        warm = 0
        for _ in range(3):
            ra.process_command(leader, make_cmd(99, warm), router=router)
            warm += 1

        def send(items, cb):
            ra.pipeline_commands(leader, items, notify_to=cb, router=router,
                                 trace_ctx=False)
        wal0 = system.wal.stats()
        row = run_clients(send, make_cmd, name)
        row.pop("acked_corrs")
        commit = settle_members(node, sids)
        wal1 = system.wal.stats()
        srvs = [node.shells[s.name].server for s in sids]
        stats = node.classic_stats()
        row.update({
            "commit_index": commit,
            "fsyncs": wal1["syncs"] - wal0["syncs"],
            "records_per_fsync": (wal1["writes"] - wal0["writes"]) /
            max(1, wal1["syncs"] - wal0["syncs"]),
            "fsync_p50_ms": wal1["fsync_p50_ms"],
            "encode_share_pct": stats.get("encode_share_pct", -1.0),
            "classic_stats": stats, "warm_commands": warm,
            "leader_changed": await_classic_leader(node, sids) != leader,
        })
        states = [s.machine_state for s in srvs]
        log = srvs[0].log
        committed = [log.fetch(i) for i in range(
            max(1, log.first_index()), commit + 1)] if want_log else []
    finally:
        node.stop()
        system.close()
    system = ra.RaSystem(data_dir)
    node = ra.RaNode("cn", router=ra.LocalRouter(), system=system,
                     device=dev)
    try:
        system.recover_servers(node, lambda c, s: factory())
        ra.trigger_election(sids[0], node.router)
        await_classic_leader(node, sids)
        settle_members(node, sids)
        recovered = [node.shells[s.name].server.machine_state for s in sids]
    finally:
        node.stop()
        system.close()
    return row, states, recovered, committed


def phase_classic_path(dev, card: str) -> dict:
    """The classic plane at bench_classic.py's phase A settings: one
    cluster of three members co-hosted on one RaNode over one RaSystem
    (one shared durable WAL on build/'s disk), 5 clients x 500 in flight,
    256-byte payloads, bursts of 64, 10 s, the noop counter with a
    release cursor every 100,000 applies; committed cmds/s, applied
    latency p50/p99, fsyncs, records per fsync and the encode share; held:
    every acknowledged command applied once on every member, an equal
    state after a reopen.  Then the same clients with JitKvMachine(64) on
    the card and seeded int32 puts and gets: the final KV state equal to a
    plain model of the acknowledged puts in log order, on every member
    and after a reopen."""
    from ra_tpu_torch.models import JitKvMachine
    mods = kernel_modules(zero=True)
    t0 = time.perf_counter()
    payload = bytes(CLASSIC_DATA_SIZE)
    row, states, recovered, _log = classic_drive(
        str(WAL_ROOT / "classic" / "noop"), dev, noop_bench_machine,
        lambda cid, seq: payload, "noop", want_log=False)
    want = row["acked"] + row["warm_commands"]
    if states != [want] * 3 or recovered != states:
        raise AssertionError(f"classic_path noop: states {states}, "
                             f"recovered {recovered}, acked+warm {want}")
    emit({"phase": "classic_path_noop", "nvidia_smi": card,
          "host_cpu": host_cpu_model(), "cores": os.cpu_count(), **row})

    keys = CLASSIC_KEYS
    kv_row, kv_states, kv_recovered, committed = classic_drive(
        str(WAL_ROOT / "classic" / "jit_kv"), dev,
        lambda: JitKvMachine(n_keys=keys), kv_bench_cmd(), "kv",
        want_log=True)
    model = kv_model([getattr(e.command, "data", None) for e in committed])
    got = [s.cpu().tolist() for s in kv_states]
    back = [s.cpu().tolist() for s in kv_recovered]
    if got != [model] * 3 or back != got or \
            {s.device.type for s in kv_recovered} != {torch.device(dev).type}:
        raise AssertionError("classic_path jit_kv: member states differ "
                             "from the plain model of the acked puts")
    kv_row.pop("classic_stats")
    emit({"phase": "classic_path_jit_kv", "nvidia_smi": card,
          "host_cpu": host_cpu_model(), "keys": keys,
          "committed_log_entries": len(committed), **kv_row})
    launches = {name: m.LAUNCHES for name, m in mods.items()}
    if any(launches.values()):
        emit({"phase": "classic_path_note",
              "launches_not_zero": launches})
    emit({"phase": "classic_path", "seconds": time.perf_counter() - t0,
          "host_launches": launches})
    return launches


# -- the classic plane across OS processes: tcp_parity and tcp_path ---------

#: bench_classic.py's phase B: one OS process a member
TCP_MEMBERS = ("cn1", "cn2", "cn3")
#: phase B's client refills a window starved this long (bench_classic.py)
TCP_CREDIT_RESET_S = 2.0


def tcp_machine(kind: str):
    """The member processes' machines, by name (registered as the machine
    spec ``chip_tcp`` in every member, so a control-plane start and a
    restart from disk build them too)."""
    from ra_tpu_torch.core.machine import SimpleMachine
    from ra_tpu_torch.models import FifoMachine, JitKvMachine
    return {"noop": lambda: noop_bench_machine(record=True),
            "snapcounter": lambda: noop_bench_machine(release=32),
            "counter": lambda: SimpleMachine(lambda c, s: s + c, 0),
            "list": lambda: SimpleMachine(lambda c, s: s + [c], []),
            "kv": lambda: JitKvMachine(n_keys=CLASSIC_KEYS),
            "kv16": lambda: JitKvMachine(n_keys=16),
            "fifo": FifoMachine}[kind]()


def tcp_member_op(node, router, system, name: str, op: str, args) -> tuple:
    """One of the parent's ops on this member; its answer's payload.  A
    cluster's server here is ``ServerId(cluster, name)``."""
    import ra_tpu_torch as ra
    from ra_tpu_torch.core.types import Membership, ServerConfig, ServerId, \
        UserCommand
    from ra_tpu_torch.machines import machine_spec, resolve_machine
    me = ServerId(args[0], name) if args and isinstance(args[0], str) \
        else None
    if op == "book":
        router.address_book.update(args[0])
    elif op == "start":
        cluster, kind, members, timeout_ms = args
        node.start_server(ServerConfig(
            server_id=me, uid=f"{cluster}_{name}", cluster_name=cluster,
            initial_members=tuple(ServerId(cluster, n) for n in members),
            machine=resolve_machine(machine_spec("chip_tcp", kind=kind)),
            election_timeout_ms=timeout_ms, tick_interval_ms=200))
    elif op == "elect":
        ra.trigger_election(me, router)
    elif op == "command":
        r = ra.process_command(me, args[1], router=router, timeout=args[2])
        return r.reply, r.leader.node
    elif op == "state":
        sh = node.shells.get(args[0])
        if sh is None:
            return ({"raft": "noproc", "state": None},)
        srv = sh.server
        st = srv.machine_state if args[1] else None
        if isinstance(st, torch.Tensor):
            st = (st.device.type, str(st.dtype), st.cpu().tolist())
        return ({"raft": srv.raft_state.value, "term": srv.current_term,
                 "commit": srv.commit_index, "applied": srv.last_applied,
                 "state": st},)
    elif op == "log":
        # the committed user commands: (correlation, data), log order
        srv = node.shells[args[0]].server
        return ([(e.command.correlation, e.command.data)
                 for e in (srv.log.fetch(i) for i in range(
                     max(1, srv.log.first_index()), srv.last_applied + 1))
                 if isinstance(e.command, UserCommand)],)
    elif op == "applied":
        return bytes(node.shells[args[0]].server.machine.applied),
    elif op == "members":
        return sorted(s.node for s in node.shells[args[0]].server.cluster),
    elif op == "metrics":
        return ra.key_metrics(me, router=router),
    elif op == "overview":
        return router.overview(),
    elif op == "partition":
        for n in args[0]:
            router.block_node(n)
    elif op == "heal":
        for n in list(router.blocked_nodes):
            router.unblock_node(n)
    elif op in ("add_member", "remove_member"):
        kw = {"membership": Membership.PROMOTABLE} \
            if op == "add_member" else {}
        return str(getattr(ra, op)(me, ServerId(args[0], args[1]),
                                   router=router, **kw)),
    elif op == "kill_wal":
        system.wal.kill()
    elif op == "wal_alive":
        return bool(system.wal.alive),
    elif op == "launches":
        return {k: m.LAUNCHES for k, m in kernel_modules().items()},
    else:
        raise ValueError(f"unknown op {op}")
    return ()


def tcp_member_main(name: str, data_dir, device, cmd_q, res_q,
                    port: int = 0) -> None:
    """One member in its own (spawned) process: a RaNode on ``device``
    behind a TcpRouter bound to ``port`` (0: a free one, reported with its
    readiness), over a RaSystem at ``data_dir`` (None: in-memory logs);
    then the parent's ops (:func:`tcp_member_op`), each answered
    ``("ok", ...)`` or ``("err", repr)``, until ``stop``."""
    import ra_tpu_torch as ra
    from ra_tpu_torch.core.machine import ApplyMeta
    from ra_tpu_torch.machines import register_machine
    from ra_tpu_torch.transport.tcp import TcpRouter
    register_machine("chip_tcp", tcp_machine)
    if device != "cpu":
        # the process's first card work (its CUDA context, the first
        # kernels) takes seconds: done here, not on the node's one
        # thread, where it would outlast the election timeout
        warm = tcp_machine("kv16")
        warm.apply(ApplyMeta(1, 1), ("put", 0, 0),
                   warm.init({"device": device}))
    router = TcpRouter(("127.0.0.1", port), {})
    system = None if data_dir is None else ra.RaSystem(data_dir)
    node = ra.RaNode(name, router=router, system=system, device=device)
    res_q.put(("ready", name, router.listen_addr[1]))
    while True:
        op, *args = cmd_q.get()
        if op == "stop":
            break
        try:
            res_q.put(("ok", *tcp_member_op(node, router, system, name, op,
                                            args)))
        except Exception as exc:  # noqa: BLE001 -- reported to the parent
            res_q.put(("err", repr(exc)))
    node.stop()
    router.stop()
    if system is not None:
        system.close()
    res_q.put(("stopped", name))


class TcpCluster:
    """Member processes over TCP, one a name, spawned (CUDA does not
    survive fork): each a RaNode on ``device`` behind a TcpRouter, over
    its own RaSystem under ``root`` (None: in-memory logs), driven over a
    pair of queues (:func:`tcp_member_op`); a client TcpRouter here on
    first use of :attr:`client`."""

    def __init__(self, names=TCP_MEMBERS, root=None, device="cpu"):
        import multiprocessing as mp
        self.ctx = mp.get_context("spawn")
        self.names, self.root, self.device = list(names), root, device
        self.ports = {n: 0 for n in self.names}
        self.chans, self.procs = {}, {}
        self.started = {n: [] for n in self.names}
        try:
            for n in self.names:
                self._spawn(n)
            for n in self.names:
                self._ready(n)
            for n in self.names:
                self.call(n, "book", self.book(n))
        except BaseException:
            self.stop()
            raise

    def _spawn(self, n: str) -> None:
        self.chans[n] = (self.ctx.Queue(), self.ctx.Queue())
        data_dir = None if self.root is None else str(Path(self.root) / n)
        self.procs[n] = self.ctx.Process(
            target=tcp_member_main, daemon=True,
            args=(n, data_dir, self.device, *self.chans[n], self.ports[n]))
        self.procs[n].start()

    def _ready(self, n: str) -> None:
        got = self._answer(n, "ready", 300)
        if got[0] != "ready":
            raise AssertionError(f"member {n}: {got}")
        self.ports[n] = got[2]

    def book(self, n: str = None) -> dict:
        """The members' addresses (but ``n``'s own)."""
        return {m: ("127.0.0.1", p) for m, p in self.ports.items() if m != n}

    def _answer(self, n: str, what: str, timeout: float):
        import queue
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self.chans[n][1].get(timeout=1.0)
            except queue.Empty:
                if not self.procs[n].is_alive():
                    raise RuntimeError(f"member {n} died awaiting {what}") \
                        from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"member {n}: no answer to {what}") \
                        from None

    def ask(self, n: str, *cmd, timeout: float = 120.0) -> tuple:
        """``n``'s answer to one op: ``("ok", ...)`` or ``("err", ...)``."""
        self.chans[n][0].put(cmd)
        return self._answer(n, cmd[0], timeout)

    def call(self, n: str, *cmd, timeout: float = 120.0) -> tuple:
        """:meth:`ask`'s payload; an error answer raises."""
        got = self.ask(n, *cmd, timeout=timeout)
        if got[0] != "ok":
            raise AssertionError(f"member {n}: {cmd[0]}: {got}")
        return got[1:]

    def start(self, cluster: str, kind: str, members=None, on=None,
              election_timeout_ms: int = 800) -> list:
        """A cluster of ``members`` (all) with its servers started on
        ``on`` (every member); a respawned member starts it again."""
        members = list(members or self.names)
        for n in on or members:
            args = (cluster, kind, members, election_timeout_ms)
            self.call(n, "start", *args)
            self.started[n].append(args)
        return members

    def serve(self, cluster: str, kind: str, warm) -> tuple:
        """Start ``cluster`` of ``kind`` on every member, elect through the
        client, and run ``warm`` through it: (server ids, leader)."""
        import ra_tpu_torch as ra
        from ra_tpu_torch.core.types import ForceElectionEvent, ServerId
        sids = [ServerId(cluster, n) for n in self.start(cluster, kind)]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            self.client.send("?", sids[0], ForceElectionEvent())
            try:
                res = ra.process_command(sids[0], warm, router=self.client,
                                         timeout=5.0)
                return sids, res.leader
            except TimeoutError:
                pass
        raise AssertionError(f"{cluster}: no leader elected over TCP")

    def leader(self, cluster: str, timeout: float = 60.0) -> str:
        """The node of a live member that reads itself leader."""
        deadline = time.monotonic() + timeout
        states = {}
        while time.monotonic() < deadline:
            for n in self.names:
                if self.procs[n].is_alive():
                    states[n] = self.call(n, "state", cluster, False)[0]
                    if states[n]["raft"] == "leader":
                        return n
            time.sleep(0.2)
        raise TimeoutError(f"{cluster}: no leader: {states}")

    def states(self, cluster: str, members=None) -> dict:
        """Each member's state once all have applied the highest commit
        index seen."""
        members = members or self.names
        deadline = time.monotonic() + 120
        while True:
            got = {n: self.call(n, "state", cluster, False)[0]
                   for n in members}
            commit = max(g["commit"] for g in got.values())
            if all(g["applied"] == commit for g in got.values()):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"{cluster}: members did not converge: "
                                     f"{got}")
            time.sleep(0.05)
        return {n: self.call(n, "state", cluster, True)[0] for n in members}

    def launches(self) -> dict:
        return {n: self.call(n, "launches")[0] for n in self.names
                if self.procs[n].is_alive()}

    def kill(self, n: str) -> None:
        self.procs[n].kill()
        self.procs[n].join(timeout=30)

    def respawn(self, n: str) -> None:
        """Restart a (killed) member over its data, on its port, and the
        clusters it served."""
        self._spawn(n)
        self._ready(n)
        self.call(n, "book", self.book(n))
        for args in self.started[n]:
            self.call(n, "start", *args)

    def partition(self, victim: str) -> None:
        """Cut ``victim`` off from every other member, both ways."""
        rest = [n for n in self.names if n != victim]
        self.call(victim, "partition", rest)
        for n in rest:
            self.call(n, "partition", [victim])

    def heal(self) -> None:
        for n in self.names:
            self.call(n, "heal")

    @functools.cached_property
    def client(self):
        from ra_tpu_torch.transport.tcp import TcpRouter
        return TcpRouter(("127.0.0.1", 0), self.book())

    def stop(self) -> None:
        if "client" in self.__dict__:
            self.client.stop()
        for n, p in self.procs.items():
            if p.is_alive():
                self.chans[n][0].put(("stop",))
        deadline = time.monotonic() + 30
        for p in self.procs.values():
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


def corr_payload(cid: int, seq: int) -> bytes:
    """Phase B's 256-byte noop payload, its correlation in the first 8
    bytes (what a recording noop machine keeps)."""
    return struct.pack("<ii", cid, seq).ljust(CLASSIC_DATA_SIZE, b"\0")


def check_acked_once(name: str, row: dict, log: list) -> None:
    """Every distinct acknowledged correlation in the committed log (or a
    member's applied sequence) ``log`` exactly once, and no client
    command in it twice."""
    client = [c for c in log if c is not None and c[0] != 99]
    counts = collections.Counter(client)
    missing = set(row["acked_corrs"]) - set(counts)
    twice = sum(1 for c in counts.values() if c > 1)
    row.update({"acked_not_in_log": len(missing), "in_log_twice": twice,
                "client_commands_in_log": len(client)})
    if missing or twice:
        raise AssertionError(f"{name}: {len(missing)} acked commands not in "
                             f"the log, {twice} in it twice")


def tcp_leg(cl: TcpCluster, cluster: str, kind: str, make_cmd) -> dict:
    """bench_classic.py's phase B clients over the cluster's TCP reach:
    the row, the leader's classic stats over node_call, the client
    router's reliable-RPC counters and dropped sends, terms.  Where no
    window was reset, no notification repeated and no leader changed,
    every command sent is acknowledged once (run_clients' strict
    check)."""
    import ra_tpu_torch as ra
    from ra_tpu_torch.telemetry import Observatory
    warm = 3
    sids, leader = cl.serve(cluster, kind, make_cmd(99, 0))
    for i in range(1, warm):
        ra.process_command(leader, make_cmd(99, i), router=cl.client)
    term0 = cl.call(leader.node, "state", cluster, False)[0]["term"]

    def send(items, cb):
        ra.pipeline_commands(leader, items, notify_to=cb, router=cl.client,
                             trace_ctx=False)
    row = run_clients(send, make_cmd, f"tcp_path {kind}",
                      reset_after_s=TCP_CREDIT_RESET_S)
    stats = ra.node_call(leader.node, "classic_stats", {}, router=cl.client,
                         timeout=30)
    obs = Observatory.for_system(None, router=cl.client)
    snap = obs.snapshot()
    obs.close()
    states = cl.states(cluster)
    terms = [st["term"] for st in states.values()]
    stable = not row["credit_resets"] and \
        not row["repeated_notifications"] and set(terms) == {term0}
    if stable and row["acked"] != row["sent"]:
        raise AssertionError(f"tcp_path {kind}: {row['sent']} sent, "
                             f"{row['acked']} acked, with no leader change")
    row.update({"warm_commands": warm, "unacked": row["sent"] - row["acked"],
                "client_dropped_sends": cl.client.dropped_sends,
                "classic_stats": stats, "strict_once_check": stable,
                "encode_share_pct": stats.get("encode_share_pct", -1.0),
                "client_rpc": snap.get("rpc", {}), "terms": terms,
                "commit_index": max(st["commit"] for st in states.values())})
    return row, states


def phase_tcp_path(dev, card: str) -> dict:
    """bench_classic.py's phase B on the port: three member processes,
    each a RaNode over its own RaSystem (WAL on build/'s disk) behind a
    TcpRouter, election timeout 800 ms, tick 200 ms; the client router
    here pipelining 5 clients x 500 in flight, 256-byte payloads, bursts
    of 64, 10 s.  The noop counter (each member keeps the correlations it
    applied, carried in the payload's first 8 bytes), then JitKvMachine(64)
    applied on the card in every member with seeded int32 puts and gets.
    Held: every acknowledged command in the committed log exactly once
    and none twice; the noop members' counts equal, the KV members'
    states equal to a plain model of the committed puts in log order."""
    mods = kernel_modules(zero=True)
    t0 = time.perf_counter()
    shutil.rmtree(WAL_ROOT / "tcp_path", ignore_errors=True)
    cl = TcpCluster(root=WAL_ROOT / "tcp_path", device=str(dev))
    try:
        row, states = tcp_leg(cl, "noop", "noop", corr_payload)
        counts = {n: st["state"] for n, st in states.items()}
        seqs = {n: [tuple(x) for x in np.frombuffer(
            cl.call(n, "applied", "noop")[0], dtype=np.int32).reshape(
                -1, 2).tolist()] for n in TCP_MEMBERS}
        # a member that installed a snapshot did not apply what it holds
        full = [n for n in TCP_MEMBERS if len(seqs[n]) == counts[n]]
        if len(set(counts.values())) != 1 or not full or \
                any(seqs[n] != seqs[full[0]] for n in full) or \
                any(len(set(seqs[n])) != len(seqs[n]) or
                    not set(seqs[n]) <= set(seqs[full[0]])
                    for n in TCP_MEMBERS):
            raise AssertionError(f"tcp_path noop: counts {counts}, applied "
                                 f"{ {n: len(s) for n, s in seqs.items()} }, "
                                 f"acked {row['acked']}")
        check_acked_once("tcp_path noop", row, seqs[full[0]])
        row.pop("acked_corrs")
        emit({"phase": "tcp_path_noop", "nvidia_smi": card,
              "host_cpu": host_cpu_model(), "cores": os.cpu_count(),
              "members_applied_all": full,
              "vs_target_20000": row["committed_cmds_per_s"] / 20_000, **row})
        kv_row, kv_states = tcp_leg(cl, "kv", "kv", kv_bench_cmd())
        log = cl.call("cn1", "log", "kv")[0]
        check_acked_once("tcp_path kv", kv_row,
                         [c and tuple(c) for c, _d in log])
        kv_row.pop("acked_corrs")
        want = (torch.device(dev).type, "torch.int32",
                kv_model([d for _c, d in log]))
        if any(st["state"] != want for st in kv_states.values()):
            raise AssertionError("tcp_path kv: member states differ from "
                                 "the plain model of the committed puts")
        kv_row.pop("classic_stats")
        emit({"phase": "tcp_path_jit_kv", "nvidia_smi": card,
              "keys": CLASSIC_KEYS, **kv_row})
        members = cl.launches()
    finally:
        cl.stop()
        shutil.rmtree(WAL_ROOT / "tcp_path", ignore_errors=True)
    launches = used_only("tcp_path", mods)
    used_only("tcp_path's members", {f"{k} {n}": v for k, m in
                                     members.items() for n, v in m.items()})
    emit({"phase": "tcp_path", "seconds": time.perf_counter() - t0,
          "host_launches": launches, "member_launches": members})
    return launches


def fifo_script(client, n: int, seed: int) -> list:
    """A seeded FifoClient script: n enqueues (one purge before them),
    then dequeues, settled or not, the unsettled ones settled in seeded
    groups, until the queue is empty; every message is dequeued once, in
    order.  Returns every dequeue and settle reply."""
    rng = np.random.default_rng(seed)
    sent = [("m", i, int(rng.integers(-2 ** 31, 2 ** 31 - 1)))
            for i in range(n)]
    for m in sent:
        client.enqueue(m)
    client.flush(timeout=60.0)
    out, held = [], []
    while True:
        settled = bool(rng.integers(0, 3) == 0)
        res = client.dequeue(settled=settled, timeout=30.0)
        if res == ("dequeue", "empty"):
            break
        out.append(res)
        if not settled:
            held.append(res[1][0])
        if held and len(held) >= int(rng.integers(1, 6)):
            out.append(("settle", client.settle(held, timeout=30.0).reply))
            held = []
    if held:
        out.append(("settle", client.settle(held, timeout=30.0).reply))
    got = [r[1][-1] for r in out if r[0] == "dequeue"]
    if got != sent:
        raise AssertionError(f"fifo script: {len(got)} of {len(sent)} "
                             "messages dequeued, or out of order")
    return out




def tcp_leader_kill(cl: TcpCluster, bursts: int = 60,
                    kill_at: int = 20) -> dict:
    """Unique values pipelined in bursts of 64 to a list machine; the
    leader's process killed at burst ``kill_at`` (its kernel launches
    read just before), the stream carried on to the new leader (fresh
    values only: an unacked one is never sent again).  Every acked value
    on every survivor once, none twice."""
    import ra_tpu_torch as ra
    sids, leader = cl.serve("plist", "list", -1)
    acked, lock = [], threading.Lock()

    def on_notify(batch):
        with lock:
            acked.extend(c for c, _r in batch)
    killed, t_kill, recovery_s, killed_launches = None, 0.0, None, None
    for b in range(bursts):
        ra.pipeline_commands(leader, [(v, v) for v in range(64 * b,
                                                            64 * b + 64)],
                             notify_to=on_notify, router=cl.client,
                             trace_ctx=False)
        time.sleep(0.01)
        if b == kill_at:
            killed = leader.node
            killed_launches = cl.call(killed, "launches")[0]
            t_kill = time.perf_counter()
            cl.kill(killed)
            rest = [s for s in sids if s.node != killed]
            deadline = time.monotonic() + 60
            while leader.node == killed:
                if time.monotonic() > deadline:
                    raise AssertionError("tcp_parity: no leader after kill")
                try:
                    leader = ra.process_command(rest[0], -2, router=cl.client,
                                                timeout=5.0).leader
                except TimeoutError:
                    pass
            recovery_s = time.perf_counter() - t_kill
    last, quiet = -1, time.monotonic()
    while time.monotonic() - quiet < 2.0:
        with lock:
            n = len(acked)
        if n != last:
            last, quiet = n, time.monotonic()
        time.sleep(0.05)
    rest = [n for n in TCP_MEMBERS if n != killed]
    lists = [st["state"] for st in cl.states("plist", rest).values()]
    final = lists[0]
    lost = len(set(acked) - set(final))
    doubled = len(final) - len(set(final))
    if any(x != final for x in lists) or lost or doubled or \
            len(set(acked)) != len(acked):
        raise AssertionError(f"tcp_parity kill: lost {lost}, doubled "
                             f"{doubled}, members equal "
                             f"{all(x == final for x in lists)}")
    return {"sent": 64 * bursts, "acked": len(acked),
            "committed": len(final), "lost_acked": lost,
            "applied_twice": doubled, "killed": killed,
            "killed_launches": killed_launches,
            "new_leader": leader.node, "recovery_s": recovery_s}


def phase_tcp_parity(dev) -> dict:
    """The classic plane over TCP against the port in one process on the
    CPU: a seeded JitKvMachine(16) script of 2,000 commands pipelined in
    order through the three member processes (state on the card) and
    through a co-hosted cluster on the CPU, every reply, state and applied
    count equal; a seeded FifoClient script (200 enqueues, dequeues and
    settles) the same on both, every message dequeued once in order; then
    a leader process killed mid-stream: 0 acked values lost, 0 applied
    twice.  The killed member's launches are read just before the kill."""
    import ra_tpu_torch as ra
    from ra_tpu_torch.models import FifoClient, FifoMachine, JitKvMachine
    mods = kernel_modules(zero=True)
    t0 = time.perf_counter()
    root = WAL_ROOT / "tcp_parity"
    shutil.rmtree(root, ignore_errors=True)
    cmds = classic_scripts(2000, seed=10)["jit_kv"]
    runs = {}
    system, node, router, sids, leader = co_hosted(
        str(root / "cpu_kv"), "cpu", lambda: JitKvMachine(n_keys=16), "pkv")
    try:
        ra.process_command(leader, ("get", 0), router=router)
        replies = pipelined(ra, leader, router, cmds)
        settle_members(node, sids)
        runs["cpu"] = (replies, [
            (str(s.machine_state.dtype), s.machine_state.tolist(),
             s.last_applied)
            for s in (node.shells[x.name].server for x in sids)])
    finally:
        node.stop()
        system.close()
    system, node, router, sids, _leader = co_hosted(
        str(root / "cpu_fifo"), "cpu", FifoMachine, "pfifo")
    try:
        ra.process_command(_leader, ("purge",), router=router)
        fifo_cpu = fifo_script(FifoClient(sids, router=router, tag="f"),
                               200, seed=11)
    finally:
        node.stop()
        system.close()
    cl = TcpCluster(root=root / "tcp", device=str(dev))
    try:
        tsids, tleader = cl.serve("pkv", "kv16", ("get", 0))
        t1 = time.perf_counter()
        replies = pipelined(ra, tleader, cl.client, cmds)
        kv_s = time.perf_counter() - t1
        states = cl.states("pkv")
        runs["tcp"] = (replies, [(st["state"][1], st["state"][2],
                                  st["applied"]) for st in states.values()])
        devices = {st["state"][0] for st in states.values()}
        if runs["tcp"] != runs["cpu"] or devices != {torch.device(dev).type}:
            raise AssertionError(f"tcp_parity kv: TCP on {devices} differs "
                                 "from the CPU run")
        fsids, _ = cl.serve("pfifo", "fifo", ("purge",))
        fifo_tcp = fifo_script(FifoClient(fsids, router=cl.client, tag="f"),
                               200, seed=11)
        if fifo_tcp != fifo_cpu:
            raise AssertionError("tcp_parity fifo: TCP differs from CPU")
        kill = tcp_leader_kill(cl)
        members = {**cl.launches(), kill["killed"]: kill["killed_launches"]}
    finally:
        cl.stop()
        shutil.rmtree(root, ignore_errors=True)
    launches = used_only("tcp_parity", mods)
    used_only("tcp_parity's members", {f"{k} {n}": v for k, m in
                                       members.items() for n, v in m.items()})
    emit({"phase": "tcp_parity", "seconds": time.perf_counter() - t0,
          "kv_commands": len(cmds), "kv_applied": runs["tcp"][1][0][2],
          "kv_tcp_cmds_per_s": len(cmds) / kv_s,
          "fifo_replies": len(fifo_tcp), "leader_kill": kill,
          "host_launches": launches, "member_launches": members})
    return launches


# -- the placement failover tier: placement_parity and placement_path -------

#: the reference test's failover size (tests/test_placement.py)
PLACEMENT_SMALL = dict(conns=4, sessions_per_conn=2, lanes=8, waves=4,
                       wave_ops=200, kill_wave=2)


def failover_checked(phase: str, **kw) -> dict:
    """``run_failover_soak`` (the soak's own oracle raises); the row's
    exactly-once counts and the failover's shape held here too."""
    from ra_tpu_torch.placement import run_failover_soak
    row = run_failover_soak(0, **kw)
    want = {"failover_lost_acked": 0, "failover_double_applied": 0,
            "downs": 1, "rehomed_sessions": kw["conns"] *
            kw["sessions_per_conn"]}
    got = {**{k: row[k] for k in want if k in row},
           "downs": row["detector"]["downs"]}
    if got != want or row["migrations"] < 1:
        raise AssertionError(f"{phase}: {got} (want {want}), "
                             f"migrations {row['migrations']}")
    return row


def phase_placement_parity(dev, state_to_numpy) -> dict:
    """The failover soak at the reference test's size on the card and on
    the CPU; the adopted engine's recovered state on the card against
    open_engine's recovery of a copy of the victim's directory on the
    CPU; then the card run with WAL disk faults."""
    from ra_tpu_torch.engine.durable import open_engine
    from ra_tpu_torch.placement import host as host_mod
    from ra_tpu_torch.wire import DedupCounterMachine
    mods = kernel_modules(zero=True)
    t0 = time.perf_counter()
    root = WAL_ROOT / "placement_parity"
    adopt, seen = host_mod.LaneEngineHost.adopt, []

    def adopt_and_keep(host, victim, victim_dir, **kw):
        # the kill-9'd directory as the survivor finds it, and the state
        # its recovery on the host's device comes to
        copy = root / f"victim_{len(seen)}"
        shutil.copytree(victim_dir, copy)
        lst = adopt(host, victim, victim_dir, **kw)
        seen.append((copy, state_to_numpy(host.adopted_engine(victim).state)))
        return lst
    rows = {}
    host_mod.LaneEngineHost.adopt = adopt_and_keep
    try:
        for name, device, kw in (("card", dev, {}), ("cpu", "cpu", {}),
                                 ("card_disk_faults", dev,
                                  {"disk_faults": True})):
            rows[name] = failover_checked(
                "placement_parity", data_dir=str(root / name), device=device,
                **PLACEMENT_SMALL, **kw)
    finally:
        host_mod.LaneEngineHost.adopt = adopt
    keys = ("failover_lost_acked", "failover_double_applied", "migrations",
            "rehomed_sessions", "conns", "sessions", "lanes")
    if {k: rows["card"][k] for k in keys} != \
            {k: rows["cpu"][k] for k in keys}:
        raise AssertionError("placement_parity: card and CPU rows differ")
    slots = 4 * max(1, 8 // PLACEMENT_SMALL["lanes"]) + 64
    compared = [seen[0], seen[2]]       # the two card runs' adoptions
    for copy, card_state in compared:
        eng = open_engine(DedupCounterMachine(slots=slots), str(copy),
                          PLACEMENT_SMALL["lanes"], wal_shards=2,
                          ring_capacity=512, max_step_cmds=16, device="cpu")
        try:
            cpu_state = state_to_numpy(eng.state)
        finally:
            eng.close()
        bad = [k for k in cpu_state
               if not np.array_equal(cpu_state[k], card_state[k])
               or cpu_state[k].dtype != card_state[k].dtype]
        if bad or cpu_state.keys() != card_state.keys():
            raise AssertionError(f"placement_parity: the adopted state on "
                                 f"the card differs from the CPU's "
                                 f"recovery in {bad[:4]}")
    shutil.rmtree(root, ignore_errors=True)
    launches = used_only("placement_parity", mods, "commit_phase")
    emit({"phase": "placement_parity", "seconds": time.perf_counter() - t0,
          "size": PLACEMENT_SMALL, "adopted_states_equal": len(compared),
          "rows": {name: {k: row[k] for k in keys + (
              "failover_recovery_s", "detector", "disk_faults_injected")}
              for name, row in rows.items()},
          "host_launches": launches})
    return launches


def phase_placement_path(dev, card: str, waves: int = 8,
                         conns: int = 10_000, kill_wave: int = 3) -> dict:
    """Two LaneEngineHosts of 1,024 lanes x 3 on the card, 10,000
    loopback connections x 2 sessions each, 8 waves of 50,000 ops a host,
    engine A kill-9'd at wave 3: the oracle, recovery seconds, counters,
    client rates around the kill and the idle share of the last two
    waves."""
    from ra_tpu_torch.metrics import PLACEMENT_FIELDS
    mods = kernel_modules(zero=True)
    data = WAL_ROOT / "placement"
    shutil.rmtree(data, ignore_errors=True)
    wt = WaveTrace(waves - 2, waves)
    t0 = time.perf_counter()
    row = failover_checked(
        "placement_path", conns=conns, sessions_per_conn=2, lanes=1024,
        waves=waves, wave_ops=50_000, kill_wave=kill_wave, wal_shards=2,
        data_dir=str(data), device=dev, on_wave=wt)
    seconds = time.perf_counter() - t0
    shutil.rmtree(data, ignore_errors=True)
    launches = used_only("placement_path", mods, "commit_phase")
    # (seconds, acked ops) as each wave starts: the rates leave out wave
    # 0 (the first acks) and the traced waves (the profiler's start)
    marks = row["wave_marks"]

    def rate(a: int, b: int) -> float:
        return (marks[b][1] - marks[a][1]) / (marks[b][0] - marks[a][0])
    traced_s, busy_s, idle = wt.busy()
    reduced = {k: [full, v] for k, full, v in (
        ("conns", 10_000, conns), ("waves", 8, waves)) if full != v}
    emit({"phase": "placement_path", "nvidia_smi": card,
          "seconds": seconds, "reduced": reduced,
          "failover_recovery_s": row["failover_recovery_s"],
          "detector": row["detector"],
          "placement_fields": {k: row["placement_counters"][k]
                               for k in PLACEMENT_FIELDS},
          "client_ops_per_s_before_kill": rate(1, kill_wave),
          "client_ops_per_s_after_kill": rate(kill_wave + 1, waves - 2),
          "wave_marks": marks, "kill_s": row["kill_s"],
          "traced_waves": [waves - 2, waves], "traced_waves_s": traced_s,
          "traced_waves_device_busy_s": busy_s,
          "traced_waves_device_idle_share": idle,
          **{k: row[k] for k in (
              "failover_lost_acked", "failover_double_applied",
              "migrations", "rehomed_sessions", "conns", "sessions",
              "lanes", "ops", "elapsed_s", "wal_shards", "host")},
          "host_launches": launches})
    return launches


# -- the geo soak across OS processes: geo_parity and geo_path --------------

def geo_checked(phase: str, dev, **kw) -> tuple:
    """``run_geo_soak`` (its own oracle raises) on ``dev``, with the row's
    exactly-once counts and the failover's shape held here too; returns
    the row and each kernel's launches in the parent (counted from 0
    here) and both engine children together."""
    from ra_tpu_torch.placement import run_geo_soak
    mods = kernel_modules(zero=True)
    row = run_geo_soak(0, device=dev, **kw)
    got = {k: row[k] for k in ("geo_lost_acked", "geo_double_applied",
                                "geo_false_migrations")}
    if got != dict.fromkeys(got, 0) or row["detector"]["downs"] != 1 or \
            row["migrations"] < 1:
        raise AssertionError(f"{phase}: {got}, detector {row['detector']}, "
                             f"migrations {row['migrations']}")
    children = row["engine_launches"].values()
    return row, {name: m.LAUNCHES + sum(c[name] for c in children)
                 for name, m in mods.items()}


def phase_geo_parity(dev) -> dict:
    """The geo soak at the reference's defaults with the engine children
    on the card and on the CPU: equal rows, and the commit phase launched
    in each card child and in no CPU child."""
    t0 = time.perf_counter()
    rows, launches = {}, {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        rows[name], launches[name] = geo_checked(
            "geo_parity", device, data_dir=str(WAL_ROOT / "geo" / name))
    keys = ("geo_lost_acked", "geo_double_applied", "geo_false_migrations",
            "ops", "sessions", "lanes", "migrations", "domain_matrix")
    pick = {name: ({k: r[k] for k in keys}, r["detector"]["downs"])
            for name, r in rows.items()}
    per_child = {name: [c["commit_phase"]
                        for c in r["engine_launches"].values()]
                 for name, r in rows.items()}
    used_only("geo_parity", launches["card"], "commit_phase")
    if pick["card"] != pick["cpu"] or min(per_child["card"]) == 0 or \
            max(per_child["cpu"]) != 0:
        raise AssertionError(f"geo_parity: {pick}, launches {launches}, "
                             f"commit_phase a child {per_child}")
    shutil.rmtree(WAL_ROOT / "geo", ignore_errors=True)
    emit({"phase": "geo_parity", "seconds": time.perf_counter() - t0,
          "rows": {name: {k: r[k] for k in keys + (
              "geo_failover_recovery_s", "detector", "elapsed_s",
              "rehome_follows", "probe_replies", "engine_launches")}
              for name, r in rows.items()},
          "launches": launches})
    return {name: launches["card"][name] + launches["cpu"][name]
            for name in launches["card"]}


def phase_geo_path(dev, card: str, sessions: int = 2048,
                   wave_ops: int = 5000) -> dict:
    """The geo soak on the card at placement_path's host size: 1,024 lanes
    and 2,048 sessions an engine, 5 waves of 5,000 ops."""
    t0 = time.perf_counter()
    row, launches = geo_checked(
        "geo_path", dev, sessions=sessions, lanes=1024, waves=5,
        wave_ops=wave_ops, data_dir=str(WAL_ROOT / "geo" / "path"))
    seconds = time.perf_counter() - t0
    shutil.rmtree(WAL_ROOT / "geo", ignore_errors=True)
    used_only("geo_path", launches, "commit_phase")
    reduced = {k: [full, v] for k, full, v in (
        ("sessions", 2048, sessions), ("wave_ops", 5000, wave_ops))
        if full != v}
    emit({"phase": "geo_path", "nvidia_smi": card, "seconds": seconds,
          "reduced": reduced,
          "geo_failover_recovery_s": row["geo_failover_recovery_s"],
          "ops_per_s": row["ops"] / row["elapsed_s"],
          **{k: row[k] for k in (
              "geo_lost_acked", "geo_double_applied", "geo_false_migrations",
              "migrations", "detector", "stale_probe_drops", "probe_replies",
              "rehome_follows", "ops", "sessions", "lanes", "elapsed_s",
              "wal_shards", "engine_launches", "host")},
          "launches": launches})
    return launches


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of ra_tpu_torch "
                                 "on one NVIDIA GPU")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the stream path's values")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # the port comes from the checkout this script sits in: alone in a
    # directory, the script stops here
    from ra_tpu_torch import devicewatch, trace
    from ra_tpu_torch.convert import state_to_numpy
    from ra_tpu_torch.engine import DispatchAheadDriver, LockstepEngine
    from ra_tpu_torch.engine.durable import open_engine
    from ra_tpu_torch.log.wal import scan_wal_file
    from ra_tpu_torch.models import CounterMachine
    from ra_tpu_torch.telemetry import TelemetrySampler
    from ra_tpu_torch.ops import _build, quorum
    from ra_tpu_torch.ops import commit_phase as cpm
    from ra_tpu_torch.ops import pallas_quorum as pq

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": _build.sources(),
          "ptxas": [ln.strip() for out in logs.values()
                    for ln in out.splitlines()
                    if "Compiling entry function" in ln
                    or "registers" in ln or "spill" in ln]})

    kernels = [phase_quorum_kernel(pq, quorum, dev),
               phase_commit_phase_kernel(cpm, dev)]
    fold_kernels = phase_fold_kernels(dev)
    # each path's launches of every kernel, counted from 0 just before it
    paths = {}
    phase_parity(pq, cpm, LockstepEngine, CounterMachine, state_to_numpy,
                 dev)
    paths["main_path"] = phase_main_path(pq, cpm, LockstepEngine,
                                         CounterMachine, dev)
    phase_superstep_parity(cpm, LockstepEngine, CounterMachine,
                           state_to_numpy, devicewatch, dev)
    volatile, paths["superstep_path"] = phase_superstep_path(
        pq, cpm, LockstepEngine, CounterMachine, DispatchAheadDriver,
        TelemetrySampler, devicewatch, dev)
    try:
        phase_wal_disk()
        phase_durable_parity(cpm, CounterMachine, open_engine,
                             state_to_numpy, scan_wal_file, dev)
        paths["durable_path"] = phase_durable_path(
            pq, cpm, CounterMachine, DispatchAheadDriver, open_engine,
            trace, state_to_numpy, dev, volatile)
        phase_durable_diagnosis(CounterMachine, DispatchAheadDriver,
                                open_engine, trace, dev)
    finally:
        shutil.rmtree(WAL_ROOT, ignore_errors=True)
    phase_machine_parity(LockstepEngine, state_to_numpy, dev)
    paths["fifo_path"] = phase_fifo_path(LockstepEngine, DispatchAheadDriver,
                                         dev)
    paths["kv_path"] = phase_kv_path(LockstepEngine, DispatchAheadDriver, dev)
    paths["stream_path"] = phase_stream_path(
        LockstepEngine, DispatchAheadDriver, dev, args.seed)
    try:
        paths["wire_path"] = phase_wire_path(dev)
        paths["tune_path"] = phase_tune_path(dev)
        paths["reads_path"] = phase_reads_path(dev)
        paths["mesh_parity"] = phase_mesh_parity(LockstepEngine,
                                                 state_to_numpy, dev)
        paths["mesh_path"] = phase_mesh_path(dev, volatile, state_to_numpy)
        paths["classic_parity"] = phase_classic_parity(dev)
        paths["classic_path"] = phase_classic_path(dev, card)
        paths["tcp_parity"] = phase_tcp_parity(dev)
        paths["tcp_path"] = phase_tcp_path(dev, card)
        paths["placement_parity"] = phase_placement_parity(dev,
                                                           state_to_numpy)
        paths["placement_path"] = phase_placement_path(dev, card)
        paths["geo_parity"] = phase_geo_parity(dev)
        paths["geo_path"] = phase_geo_path(dev, card)
    finally:
        shutil.rmtree(WAL_ROOT, ignore_errors=True)
    # "launches" is the count on the kernel's own path (the main path for
    # the commit phase and the quorum, the fifo path's consumer mix and
    # the kv path's cas mix for the two folds); a machine path's counts
    # are by mix, the wire path's the host's
    folds = {"slot_fold": paths["kv_path"]["b_cas"],
             "fifo_fold": paths["fifo_path"]["b_consumer"]}
    for k in kernels + fold_kernels:
        name = k["name"]
        for path, got in paths.items():
            k[f"launches_{path}"] = got["host"][name] if "host" in got \
                else got[name] if name in got \
                else {mix: v["host"][name] for mix, v in got.items()}
        if name in folds:
            k["launches"] = folds[name]["host"][name]
            k["executions_profiled"] = folds[name]["profiled_executions"]
        else:
            k["launches"] = paths["main_path"][name]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels + fold_kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
