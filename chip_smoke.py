#!/usr/bin/env python3
"""Smoke run of ra_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero (there is no CPU path and no fallback to a plain version):

  device     the card, and its name and power limit from nvidia-smi
  build      nvcc builds every kernel of ra_tpu_torch/ops/csrc for sm_90a
  kernels    each kernel against its plain torch version on the card at
             the main path's shape and more, exactly: the commit quorum
             (evaluate_quorum, the public API's kernel) and the fused
             commit phase (commit_phase, the step's kernel, every output
             and dtype, both block sizes); kernel and plain version
             timed with CUDA events, per call (host launch included) and
             back to back in a CUDA graph (device only)
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

then the kernels summary line (launches on the main path, and on the
superstep path its host launches, captured launches and profiled
executions), the nvidia-smi line, and last {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
NON_TENSOR_OPS_PER_S = 67e12   # H100 SXM fp32 outside the tensor cores


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


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


def phase_quorum_kernel(pq, quorum, dev) -> dict:
    checks = []
    for n, p in ((10_000, 5), (513, 2), (1024, 7), (4099, 15), (2048, 16)):
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
    kernel_ms = cuda_ms(lambda: pq.evaluate_quorum_cuda(*args))
    plain_ms = cuda_ms(lambda: quorum.evaluate_quorum(*args))
    kernel_graph_ms = graph_ms(lambda: pq.evaluate_quorum_cuda(*args))
    plain_graph_ms = graph_ms(lambda: quorum.evaluate_quorum(*args))
    n_bytes = n * (4 * p + p + 12)          # each input once, output once
    n_ops = n * (2 * p * p + 4 * p + 8)     # pairwise count + select + gate
    bound_ms, bound_by = bound(n_bytes, n_ops)
    emit({"phase": "kernels", "kernel": "evaluate_quorum", "checks": checks,
          "shape": [n, p], "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "kernel_graph_ms": kernel_graph_ms,
          "plain_graph_ms": plain_graph_ms,
          "bound_ms": bound_ms, "bytes": n_bytes, "ops": n_ops})
    return {"name": "evaluate_quorum", "route": "cuda",
            "source": "ra_tpu_torch/ops/csrc/quorum.cu",
            "replaces": "ra_tpu/ops/pallas_quorum.py:47",
            "exact": all(c["exact"] for c in checks),
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "shape": [n, p], "kernel_ms": kernel_ms, "ms": kernel_ms,
            "plain_ms": plain_ms, "kernel_graph_ms": kernel_graph_ms,
            "plain_graph_ms": plain_graph_ms, "bound_ms": bound_ms,
            "bytes": n_bytes, "bound_by": bound_by,
            # no single PyTorch call computes a voter-masked median with
            # the term gate
            "library_ms": None}


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
    kernel_ms = cuda_ms(lambda: cpm.commit_phase_cuda(*args, **kw))
    plain_ms = cuda_ms(lambda: cpm.commit_phase(*args, **kw))
    kernel_graph_ms = graph_ms(lambda: cpm.commit_phase_cuda(*args, **kw))
    plain_graph_ms = graph_ms(lambda: cpm.commit_phase(*args, **kw))
    # each input read once, each output written once: [N,P] 6 int32 and
    # 2 bool in, 4 int32 out; [N] 11 int32 and 3 bool in, 12 int32 and
    # 2 bool out
    n_bytes = sum(t.numel() * t.element_size() for t in args) + \
        n * (4 * 4 * p + 12 * 4 + 2)
    # two P x P selections, the per-member fold and the lane scalars
    n_ops = n * (2 * 3 * p * p + 20 * p + 40)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    emit({"phase": "kernels", "kernel": "commit_phase", "checks": checks,
          "shape": [n, p], "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "kernel_graph_ms": kernel_graph_ms,
          "plain_graph_ms": plain_graph_ms,
          "bound_ms": bound_ms, "bytes": n_bytes, "ops": n_ops})
    return {"name": "commit_phase", "route": "cuda",
            "source": "ra_tpu_torch/ops/csrc/commit_phase.cu",
            "replaces": "ra_tpu/ops/pallas_quorum.py:47",
            "also_replaces": "ra_tpu/engine/lockstep.py:450-535",
            "exact": True,
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "shape": [n, p], "kernel_ms": kernel_ms, "ms": kernel_ms,
            "plain_ms": plain_ms, "kernel_graph_ms": kernel_graph_ms,
            "plain_graph_ms": plain_graph_ms, "bound_ms": bound_ms,
            "bytes": n_bytes, "bound_by": bound_by,
            # no single PyTorch call computes the commit phase
            "library_ms": None}


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
    pq.LAUNCHES = cpm.LAUNCHES = 0
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
    launches = {"commit_phase": cpm.LAUNCHES,
                "evaluate_quorum": pq.LAUNCHES}
    steps = eng.pipeline_counters["inner_steps"]
    if launches != {"commit_phase": steps, "evaluate_quorum": 0}:
        raise AssertionError(f"kernel launches {launches} in {steps} "
                             "main-path steps; want one commit_phase a "
                             "step and no evaluate_quorum")
    emit({"phase": "main_path", "lanes": N, "members": P,
          "cmds_per_step": cmds, "timed_steps": timed,
          "committed_cmds_per_s": (committed1 - committed0) / seconds,
          "ms_per_step": seconds / timed * 1e3,
          "committed_per_lane": want, "leader_counter_ok": True,
          "read_lanes_ok": True, "read_watermark_min": int(wm.min()),
          "engine_steps": steps, "kernel_launches": launches,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    return launches


def stacked_steps(eng, n_new, pay, **kw) -> dict:
    """K eager ``step()`` calls, the aux stacked as superstep stacks it;
    ``kw`` holds superstep's schedule keywords."""
    from ra_tpu_torch.engine.lockstep import step_watermarks
    names = {"elect_blk": "elect_mask", "query_blk": "query_mask",
             "n_read_blk": "n_read", "read_q_blk": "read_q"}
    auxes = []
    for j in range(n_new.shape[0]):
        aux = eng.step(n_new[j], pay[j],
                       **{names[k]: v[j] for k, v in kw.items()})
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
        captures0 = devicewatch.WATCH.counters["graph_captures"]
        failed, held, clipped = [], None, 0
        dispatches = 5
        for d in range(dispatches):
            leader = cpu.state.leader_slot.numpy()
            heal = [(lane, slot) for lane, slot in failed
                    if slot != leader[lane]]
            if heal:
                lanes, slots = zip(*heal)
                for e in engines:
                    e.recover_members(list(lanes), list(slots))
            # fail the leader of 32 lanes, which elect at inner step 3,
            # and a follower of 32 more
            lanes = rng.choice(N, size=64, replace=False)
            failed = [(int(lane), int(leader[lane])) for lane in lanes[:32]]
            failed += [(int(lane), (int(leader[lane]) + 1) % P)
                       for lane in lanes[32:]]
            for e in engines:
                for lane, slot in failed:
                    e.fail_member(lane, slot)
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
                devicewatch.WATCH.counters["graph_captures"] - captures0 \
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


def phase_superstep_path(pq, cpm, LockstepEngine, CounterMachine,
                         DispatchAheadDriver, TelemetrySampler, devicewatch,
                         dev, n_lanes: int = 10_000) -> dict:
    from ra_tpu_torch.step_profile import device_rows
    N, P, cmds, K = n_lanes, 5, 128, 8
    warm, timed, profiled = 2, 25, 3
    pq.LAUNCHES = cpm.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    eng = LockstepEngine(CounterMachine(), N, P, ring_capacity=1024,
                         max_step_cmds=cmds, apply_window=130, write_delay=1,
                         device=dev)
    sampler = TelemetrySampler(eng)
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    # the bench's staged blocks: host numpy, 41 MB of payload a block
    n_blk = np.broadcast_to(np.full(N, cmds, np.int32), (K, N))
    p_blk = np.broadcast_to(np.ones((N, cmds, 1), np.int32),
                            (K, N, cmds, 1))
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
    t0 = time.perf_counter()
    for _ in range(timed):
        drv.submit(n_blk, p_blk)
    drv.drain()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    window_wait_ms = (drv.window_wait_s - wait0) / timed * 1e3
    phases = eng.phases.overview()
    committed1 = eng.committed_total()
    watch1, sites1 = dict(devicewatch.WATCH.counters), ledger(devicewatch)
    pc = {k: eng.pipeline_counters[k] - pc0[k] for k in pc0}
    captures = watch1["graph_captures"] - watch0["graph_captures"]
    recaptures = watch1["graph_recaptures"] - watch0["graph_recaptures"]
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
    groups = device_rows(prof)
    rows = groups["kernels"]
    executions = sum(e.count for e in rows if "commit_phase_kernel" in e.key)
    # the dispatch stream's busy time (kernels and device-to-device
    # copies); the block's host-to-device copy overlaps it on a copy
    # engine and is reported apart
    kernel_ms = sum(e.self_device_time_total for e in rows) / 1e3
    busy_ms = kernel_ms + sum(e.self_device_time_total
                              for e in groups["copies"]) / 1e3
    transfer_ms = sum(e.self_device_time_total
                      for e in groups["transfers"]) / 1e3
    if executions != profiled * K:
        raise AssertionError(f"{executions} commit_phase executions in a "
                             f"profiler window of {profiled * K} inner "
                             "steps")
    graph = eng._graphs._graphs[(K, cmds, False)]
    launches = {"commit_phase": cpm.LAUNCHES,
                "evaluate_quorum": pq.LAUNCHES}
    # host launches: for each of the two graphs (K and 1) the warm-up
    # before its capture, and the capture
    if graph.captured_launches["commit_phase"] != K or \
            launches != {"commit_phase": 2 * (K + 1), "evaluate_quorum": 0}:
        raise AssertionError(f"superstep path launches {launches}, "
                             f"captured {graph.captured_launches}; want "
                             f"{K + 1} warm-up and {K + 1} captured "
                             "commit_phase launches and no evaluate_quorum")
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
    emit({"phase": "superstep_path", "lanes": N, "members": P,
          "superstep_k": K, "cmds_per_step": cmds, "timed_dispatches": timed,
          "ms_per_inner_step": seconds / (timed * K) * 1e3,
          "committed_cmds_per_s": (committed1 - committed0) / seconds,
          "window_syncs": pc["window_syncs"],
          "window_wait_ms_per_dispatch": window_wait_ms,
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
    return {name: {"host_launches": launches[name],
                   "captured_per_graph": graph.captured_launches[name],
                   "profiled_executions": sum(
                       e.count for e in rows if f"{name}_kernel" in e.key),
                   "profiled_inner_steps": profiled * K}
            for name in launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # the port comes from the checkout this script sits in: alone in a
    # directory, the script stops here
    from ra_tpu_torch import devicewatch
    from ra_tpu_torch.convert import state_to_numpy
    from ra_tpu_torch.engine import DispatchAheadDriver, LockstepEngine
    from ra_tpu_torch.models import CounterMachine
    from ra_tpu_torch.telemetry import TelemetrySampler
    from ra_tpu_torch.ops import _build, quorum
    from ra_tpu_torch.ops import commit_phase as cpm
    from ra_tpu_torch.ops import pallas_quorum as pq

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
    phase_parity(pq, cpm, LockstepEngine, CounterMachine, state_to_numpy,
                 dev)
    launches = phase_main_path(pq, cpm, LockstepEngine, CounterMachine, dev)
    phase_superstep_parity(cpm, LockstepEngine, CounterMachine,
                           state_to_numpy, devicewatch, dev)
    ss_launches = phase_superstep_path(
        pq, cpm, LockstepEngine, CounterMachine, DispatchAheadDriver,
        TelemetrySampler, devicewatch, dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_superstep_path"] = ss_launches[k["name"]]
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
