"""Device-mesh sharding for the lane engine.

The counterpart of ``ra_tpu/parallel/mesh.py``.  Its two axes:

* ``lanes`` -- cluster-level data parallelism: lanes are independent, so
  a lane shard runs the unchanged step on its own device with no
  traffic between devices.
* ``members`` -- the replication axis: the member columns of every
  ``[N, P, ...]`` leaf are split over the member slots of a lane shard's
  mesh column.

The reference lays one global array over the mesh and lets XLA insert
the collectives (GSPMD).  The port has no global sharded tensor: a
sharded ``LockstepEngine`` keeps one lane shard a lanes slot
(``engine/shards.py``), each running the step on its home slot
``(0, j)``, and a split members axis is gathered onto the home slot
before a dispatch and scattered back after it, by device-to-device
copies.  That is a departure of placement, not of results: the state
after every dispatch equals the unsharded engine's leaf for leaf.

A mesh is a 2-D grid of torch devices.  Its slots may repeat a device:
``lane_mesh(["cpu"] * 8)`` is the CPU counterpart of the reference's 8
forced host devices, ``lane_mesh(["cuda:0"] * 4)`` four slots on one
card, and ``lane_mesh()`` one slot a visible card.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import devicewatch
from ..core.tree import tree_leaves, tree_map
from ..device import resolve_device
from ..engine.driver import DispatchAheadDriver
from ..engine.shards import LANE_LOCAL


class LaneMesh:
    """A ``(members, lanes)`` grid of torch devices: ``devices[i, j]`` is
    member slot ``i`` of lane slot ``j``."""

    def __init__(self, devices: np.ndarray) -> None:
        self.devices = devices

    @property
    def shape(self) -> dict:
        m, n_l = self.devices.shape
        return {"members": m, "lanes": n_l}

    def distinct_devices(self) -> list:
        """The mesh's devices without repeats, in slot order."""
        out: list = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def __eq__(self, other) -> bool:
        return isinstance(other, LaneMesh) and \
            self.devices.shape == other.devices.shape and \
            all(a == b for a, b in zip(self.devices.flat,
                                       other.devices.flat))

    def __repr__(self) -> str:
        return (f"LaneMesh({self.shape}, "
                f"{[str(d) for d in self.distinct_devices()]})")


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` names the current card)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def lane_mesh(devices: Optional[Sequence] = None,
              member_axis: int = 1) -> LaneMesh:
    """Build a ``(members, lanes)`` mesh of ``devices`` (default: every
    visible card; raises where there is none), ``member_axis`` rows of
    ``len(devices) / member_axis`` slots, in the order given.
    ``member_axis=1`` is the pure lane-parallel deployment.  Devices may
    repeat, and every one goes through ``resolve_device``: a mesh that
    cannot be built raises, it never quietly becomes one device."""
    if devices is None:
        resolve_device(None)            # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_indexed(resolve_device(d)) for d in devices]
    n = len(devs)
    if n == 0 or member_axis < 1 or n % member_axis:
        raise ValueError(f"{n} devices do not make {member_axis} member "
                         "rows")
    arr = np.empty((n,), dtype=object)
    arr[:] = devs
    return LaneMesh(arr.reshape(member_axis, n // member_axis))


def state_shardings(mesh: LaneMesh, state) -> object:
    """The placement of every ``LaneState`` leaf, as the reference's
    partition specs (tuples of axis names): ``[N]`` fields over
    ``'lanes'``, ``[N, P, ...]`` fields and the machine state over
    ``('lanes', 'members', None...)``, the ring, ``read_buf`` and the
    telemetry over ``'lanes'`` only."""
    def spec(leaf, member: bool) -> tuple:
        if leaf.dim() == 0:
            return ()
        dims = ["lanes"]
        if member and leaf.dim() >= 2:
            dims.append("members")
        return tuple(dims + [None] * (leaf.dim() - len(dims)))

    return type(state)(**{
        name: tree_map(lambda x, n=name: spec(x, n not in LANE_LOCAL),
                       getattr(state, name))
        for name in type(state)._fields})


def shard_engine_state(engine, mesh: Optional[LaneMesh] = None) -> LaneMesh:
    """Place an engine's state over ``mesh`` (default: ``lane_mesh()``);
    every later ``step``/``superstep`` runs once a lane shard on its home
    slot, and the results equal the unsharded engine's.  ``engine._mesh``
    records the mesh, so that the driver and the ingress plane stage
    their blocks per shard.  The transfer ledger counts the placement
    once, at the ``mesh_shard`` site; a dispatch adds nothing to it."""
    if mesh is None:
        mesh = lane_mesh()
    engine._shard(mesh)
    leaves = [x for _lo, _n, st in engine.lane_shard_states()
              for x in tree_leaves(st)]
    leaves += [b for sh in engine._shards for blk in sh.blocks for b in blk]
    leaves += [z for sh in engine._shards for z in sh.zeros.values()]
    devicewatch.record_h2d("mesh_shard",
                           sum(x.numel() * x.element_size() for x in leaves),
                           events=len(leaves))
    return mesh


class LaneSharding:
    """The placement of a ``[K, N, ...]`` staged block over a mesh: the
    lanes on axis ``spec.index('lanes')``, one piece a lane slot."""

    def __init__(self, mesh: LaneMesh, spec: tuple) -> None:
        self.mesh = mesh
        self.spec = spec


def superstep_block_shardings(mesh: LaneMesh) -> dict:
    """Placements of the ``[K, ...]`` superstep staging block: the inner
    step axis is time and never split; the lanes are split as the
    state's, so a staged piece lands on its shard's home device and the
    dispatch reads it there.  No ``elect`` entry: elect schedules are
    host data (the engine counts elections on the host)."""
    vec = LaneSharding(mesh, (None, "lanes"))
    return {
        "n_new": vec,
        "payloads": LaneSharding(mesh, (None, "lanes", None, None)),
        "query": vec,
        "n_read": vec,
        "read_q": LaneSharding(mesh, (None, "lanes", None, None)),
    }


#: the multichip lane ladder shared by ``bench.py --multichip`` and the
#: dryrun's throughput and chaos phases
DEFAULT_LANE_LADDER = (1024, 8192, 65536)


def lane_ladder(env: Optional[str] = None) -> list:
    """The multichip lane ladder: an explicit ``env`` string, else the
    ``RA_TPU_MULTICHIP_LANES`` environment variable, else the default.
    Spaces are allowed; an empty or unparsable spec gives the default."""
    raw = env if env is not None else \
        os.environ.get("RA_TPU_MULTICHIP_LANES", "")
    try:
        rungs = [int(x.strip()) for x in raw.split(",") if x.strip()]
    except ValueError:
        rungs = []
    return rungs or list(DEFAULT_LANE_LADDER)


def mesh_shapes(n_devices: int) -> list:
    """``[(member_axis, lane_axis, members), ...]`` the multichip sweeps
    enumerate: the lane-parallel ``1xD`` with 3 members, and the
    ``2x(D/2)`` member-replicated deployment with 4 members where the
    slot count allows."""
    shapes = [(1, n_devices, 3)]
    if n_devices % 2 == 0 and n_devices >= 4:
        shapes.append((2, n_devices // 2, 4))
    return shapes


def ladder_rungs(ladder, lane_devices: int) -> list:
    """Each rung clamped to at least 16 lanes a lane slot, deduplicated
    and sorted."""
    return sorted({max(int(r), 16 * lane_devices) for r in ladder})


def per_device_wal_shards(mesh: LaneMesh) -> int:
    """WAL shards for the per-device durable layout: one a lane slot.
    ``EngineDurability`` splits the lanes as the mesh does, so WAL shard
    ``i`` writes lane shard ``i``'s rows, read off that shard's device."""
    return int(mesh.shape["lanes"])


def mesh_superstep_driver(engine, mesh: Optional[LaneMesh] = None,
                          max_in_flight: int = 2) -> DispatchAheadDriver:
    """A ``DispatchAheadDriver`` staging its blocks with
    ``superstep_block_shardings``: each piece of a block goes straight to
    its shard's device while the previous dispatch runs.  Shards the
    engine over ``lane_mesh()`` first if it is not sharded."""
    mesh = mesh or engine._mesh
    if mesh is None:
        mesh = shard_engine_state(engine)
    return DispatchAheadDriver(engine, max_in_flight=max_in_flight,
                               shardings=superstep_block_shardings(mesh))


def drive_uniform_window(driver: DispatchAheadDriver, n_new_blk,
                         payloads_blk, seconds: float, *, observe=None):
    """The mesh driver's measured loop: staged superstep submits back to
    back for ``seconds``, with no device-to-host sync but the driver's
    in-flight cap.  ``observe()`` runs between dispatches (host work: an
    Observatory snapshot, an autotuner tick) and may return a new
    ``(n_new_blk, payloads_blk)`` to restage at another K.  Returns
    ``(dispatches, inner_steps, elapsed_s)``; the caller drains."""
    dispatches = 0
    inner = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        driver.submit(n_new_blk, payloads_blk)
        dispatches += 1
        inner += int(n_new_blk.shape[0])
        if observe is not None:
            nxt = observe()
            if nxt is not None:
                n_new_blk, payloads_blk = nxt
    return dispatches, inner, time.perf_counter() - t0


def ingress_submit_wave(plane, handles, seqnos, payloads):
    """One vectorized submission wave into a sharded engine's ingress
    plane (dedup, admission, coalescing, staged dispatch); returns the
    per-row status."""
    status = plane.submit(handles, seqnos, payloads)
    plane.pump(force=True)
    return status
