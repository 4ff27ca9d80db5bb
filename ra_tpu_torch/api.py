"""Public API — the ra.erl equivalent (cited: ra.erl).

Functions mirror the reference surface: start_cluster/4 (:374),
process_command/3 (:804-828) with follower->leader redirect,
pipeline_command/4 (:886-896), local_query (:962), leader_query (:1012),
consistent_query (:1051), members, add_member (:593), remove_member (:628),
trigger_election (:660), transfer_leadership (:687), delete_cluster (:556),
restart_server (:188), key_metrics (:1229).

All calls are synchronous wrappers around effect-routed futures; the
engine-based deployments expose the same verbs through the lane engine's
host API instead.
"""
from __future__ import annotations

import time
import uuid
from typing import Any, Callable, Optional

from .core.types import (
    CommandResult,
    ConsistentQueryEvent,
    ErrorResult,
    ForceElectionEvent,
    ForceMemberChangeEvent,
    JoinCommand,
    LeaveCommand,
    ClusterDeleteCommand,
    Membership,
    Priority,
    ReplyMode,
    ServerConfig,
    ServerId,
    TransferLeadershipEvent,
    UserCommand,
)
from . import trace
from .blackbox import record
from .node import DEFAULT_ROUTER, Future, LocalRouter, RaNode


def new_uid(prefix: str = "") -> str:
    """Unique, filesystem-safe server UID (ra:new_uid/1 :735).  The
    caller-supplied prefix (typically a server name) is sanitized to the
    base64url alphabet the storage layer enforces — uids name on-disk
    directories (RaSystem.validate_uid)."""
    import re
    safe = re.sub(r"[^A-Za-z0-9_\-=]", "_", prefix)
    return f"{safe}{uuid.uuid4().hex[:12]}"


def node_call(node_name: str, op: str, args: dict,
              router: Optional[LocalRouter] = None,
              timeout: float = 60.0) -> Any:
    """Node-lifecycle RPC — the rpc:call of ra_server_sup_sup.erl:42-130.
    Reaches a LOCAL RaNode directly; a REMOTE one rides the reliable
    control-plane RPC layer (transport/rpc.py): a stable request id
    retried with backoff until the deadline, deduplicated receiver-side
    so the op executes at most once, with reconnect-aware routing past
    peer restarts.  Raises the typed triad — ``Unreachable`` (no route
    / detector-down peer), ``RpcTimeout`` (reachable but unanswered by
    the deadline), ``RemoteError`` (the remote executor failed) — all
    RuntimeError subclasses; RpcTimeout is also a TimeoutError."""
    from .core.types import NODE_SCOPE, NodeControlEvent
    from .transport.rpc import reliable_node_call
    router = router or DEFAULT_ROUTER
    node = router.nodes.get(node_name)
    if node is not None:
        fut = Future()
        node.deliver(ServerId(NODE_SCOPE, node_name),
                     NodeControlEvent(op, args, from_=fut))
        return fut.wait(timeout)
    return reliable_node_call(router, node_name, op, args, timeout=timeout)


def _config_snapshot_for(cluster_name: str, spec: tuple, sid: ServerId,
                         server_ids: list, uid: str,
                         election_timeout_ms: int, tick_interval_ms: int,
                         membership: Membership = Membership.VOTER) -> dict:
    return {
        "server_id": tuple(sid),
        "uid": uid,
        "cluster_name": cluster_name,
        "initial_members": tuple(tuple(m) for m in server_ids),
        "election_timeout_ms": election_timeout_ms,
        "tick_interval_ms": tick_interval_ms,
        "membership": membership.value,
        "machine_spec": spec,
    }


def start_cluster(cluster_name: str, machine_factory: Any,
                  server_ids: list, router: Optional[LocalRouter] = None,
                  election_timeout_ms: int = 100,
                  tick_interval_ms: int = 100,
                  log_init_args: Optional[dict] = None) -> list:
    """Start every member and trigger an election (ra:start_cluster/5 :374).

    ``machine_factory`` is either a zero-arg callable returning a
    Machine (members on LOCAL RaNodes only), or a machine SPEC from
    :func:`ra_tpu_torch.machines.machine_spec` — with a spec, members whose
    node is not on this process's router are started REMOTELY over the
    control plane (the multi-node ra:start_cluster flow, which the
    reference routes through ra_server_sup_sup's rpc:call).

    Formation follows the reference (ra.erl:397-409): the cluster forms
    when MORE THAN HALF of the members started — stragglers can be
    retried with start_server later; on failure to form, every member
    that did start is force-deleted and RuntimeError('cluster_not_
    formed') is raised."""
    from .machines import is_machine_spec, resolve_machine
    router = router or DEFAULT_ROUTER
    spec = machine_factory if is_machine_spec(machine_factory) else None
    started: list = []
    failures: list = []
    for sid in server_ids:
        node = router.nodes.get(sid.node)
        uid = new_uid(f"{sid.name}_")
        try:
            if node is None:
                if spec is None:
                    raise RuntimeError(
                        f"no RaNode registered for {sid.node} and no "
                        "machine spec to start it remotely")
                res = node_call(sid.node, "start_server", {
                    "config": _config_snapshot_for(
                        cluster_name, spec, sid, server_ids, uid,
                        election_timeout_ms, tick_interval_ms)}, router)
                if isinstance(res, ErrorResult):
                    raise RuntimeError(
                        f"remote start of {sid} failed: {res.reason}")
            else:
                machine = resolve_machine(spec) if spec is not None \
                    else machine_factory()
                cfg = ServerConfig(server_id=sid, uid=uid,
                                   cluster_name=cluster_name,
                                   initial_members=tuple(server_ids),
                                   machine=machine,
                                   election_timeout_ms=election_timeout_ms,
                                   tick_interval_ms=tick_interval_ms,
                                   log_init_args=dict(log_init_args or {}))
                node.start_server(cfg)
        except (RuntimeError, TimeoutError, ValueError) as exc:
            failures.append((sid, exc))
            continue
        started.append(sid)
    if len(started) * 2 <= len(server_ids):
        # cluster_not_formed: force-delete whatever did start
        # (ra.erl:407-409 — leftovers would be amnesiac split fragments)
        for sid in started:
            try:
                force_delete_server(sid, router=router)
            except (RuntimeError, TimeoutError):
                pass
        raise RuntimeError(
            f"cluster_not_formed: {len(started)}/{len(server_ids)} "
            f"members started; failures: "
            f"{[(str(s), repr(e)[:120]) for s, e in failures]}")
    # nudge a started member so a fresh cluster elects promptly
    trigger_election(started[0], router)
    return started


def start_server(cluster_name: str, machine_factory: Any,
                 server_id: ServerId, initial_members: list,
                 router: Optional[LocalRouter] = None,
                 election_timeout_ms: int = 100,
                 tick_interval_ms: int = 100,
                 membership: Membership = Membership.VOTER,
                 log_init_args: Optional[dict] = None) -> Any:
    """Start one member without electing (ra:start_server/4) — used before
    add_member to bring the new member up.  Accepts a machine spec like
    start_cluster, and starts on remote nodes over the control plane."""
    from .machines import is_machine_spec, resolve_machine
    router = router or DEFAULT_ROUTER
    spec = machine_factory if is_machine_spec(machine_factory) else None
    node = router.nodes.get(server_id.node)
    uid = new_uid(f"{server_id.name}_")
    if node is None:
        if spec is None:
            raise RuntimeError(
                f"no RaNode registered for {server_id.node} and no "
                "machine spec to start it remotely")
        res = node_call(server_id.node, "start_server", {
            "config": _config_snapshot_for(
                cluster_name, spec, server_id, list(initial_members), uid,
                election_timeout_ms, tick_interval_ms, membership)},
            router)
        if isinstance(res, ErrorResult):
            raise RuntimeError(f"remote start of {server_id} failed: "
                               f"{res.reason}")
        return res
    machine = resolve_machine(spec) if spec is not None \
        else machine_factory()
    cfg = ServerConfig(server_id=server_id,
                       uid=uid,
                       cluster_name=cluster_name,
                       initial_members=tuple(initial_members),
                       machine=machine,
                       election_timeout_ms=election_timeout_ms,
                       tick_interval_ms=tick_interval_ms,
                       membership=membership,
                       log_init_args=dict(log_init_args or {}))
    return node.start_server(cfg)


def restart_server(server_id: ServerId,
                   router: Optional[LocalRouter] = None,
                   mutable_config: Optional[dict] = None) -> Any:
    """Stop and re-init one member over its existing log
    (ra:restart_server/2,3 :188-199).  For members on remote nodes this
    goes over the control plane, recovering the persisted config from
    the target node's disk (restart_server_rpc + recover_config,
    ra_server_sup_sup.erl:80-103).  ``mutable_config`` merges
    whitelisted keys (RaNode.MUTABLE_CONFIG_KEYS — the reference's
    ?MUTABLE_CONFIG_KEYS) into the recovered config."""
    router = router or DEFAULT_ROUTER
    node = router.nodes.get(server_id.node)
    if node is not None:
        return node.restart_server(server_id.name, mutable=mutable_config)
    res = node_call(server_id.node, "restart_server",
                    {"name": server_id.name, "mutable": mutable_config},
                    router)
    if isinstance(res, ErrorResult):
        raise RuntimeError(f"remote restart of {server_id} failed: "
                           f"{res.reason}")
    return res


def stop_server(server_id: ServerId,
                router: Optional[LocalRouter] = None) -> None:
    """Gracefully stop one member; its durable state stays on disk
    (ra:stop_server/2).  Remote members stop over the control plane."""
    router = router or DEFAULT_ROUTER
    node = router.nodes.get(server_id.node)
    if node is not None:
        node.stop_server(server_id.name)
        return
    node_call(server_id.node, "stop_server", {"name": server_id.name},
              router)


def force_delete_server(server_id: ServerId, system=None,
                        router: Optional[LocalRouter] = None) -> None:
    """Stop one member and wipe its durable footprint without consensus
    (ra:force_delete_server/2 — used when the cluster is already gone).
    Pass the member's RaSystem to delete its on-disk data.  Works on a
    stopped member too: the uid then resolves through the system
    directory rather than the live shell.  For a member on a REMOTE
    node, the control plane deletes against the target node's own
    system (no ``system`` argument needed)."""
    router = router or DEFAULT_ROUTER
    if router.nodes.get(server_id.node) is None:
        res = node_call(server_id.node, "force_delete_server",
                        {"name": server_id.name}, router)
        if isinstance(res, ErrorResult):
            raise RuntimeError(f"remote force_delete of {server_id} "
                               f"failed: {res.reason}")
        return
    node = _node_of(server_id, router)
    shell = node.shells.get(server_id.name)
    uid = shell.server.cfg.uid if shell is not None else None
    if uid is None and system is not None:
        uid = system.directory.where_is(server_id.name)
    node.kill_server(server_id.name)
    node.forget_server(server_id.name)
    node.wipe_member_footprint(uid, system)


def _node_of(sid: ServerId, router: LocalRouter) -> RaNode:
    node = router.nodes.get(sid.node)
    if node is None:
        raise RuntimeError(f"node {sid.node} is not running")
    return node


def _leader_call(seed: ServerId, make_event: Callable[["Future"], Any],
                 router: LocalRouter, timeout: float,
                 retry_reasons: tuple = (),
                 timeout_msg: str = "ra: command not completed",
                 trace_ctx: Optional[str] = None) -> Any:
    """Shared redirect/retry loop for leader-targeted calls — the
    equivalent of ra_server_proc's leader_call redirect machinery
    (ra_server_proc.erl:242-263).  make_event builds the event to submit
    given the reply Future.  not_leader redirects follow the hinted
    leader; reasons in retry_reasons back off and retry in place.
    ``trace_ctx`` records one ``cmd.submit`` hop event per attempt —
    redirects and retries become visible in the command's timeline."""
    deadline = time.monotonic() + timeout
    target = seed
    last_err: Any = None
    attempt = 0
    while time.monotonic() < deadline:
        node = router.nodes.get(target.node)
        attempt += 1
        if trace_ctx is not None:
            record("cmd.submit", trace=trace_ctx, target=str(target),
                   attempt=attempt,
                   transport="local" if node is not None else "remote")
        if node is not None:
            fut = Future()
            if not node.submit(target.name, make_event(fut)):
                last_err = ErrorResult("noproc", None)
                target = seed
                time.sleep(0.01)
                continue
        else:
            # remote node: full cross-host call (TcpRouter); in-process
            # routers have no reach and report noproc
            fut = router.remote_call(target, make_event)
            if fut is None:
                last_err = ErrorResult("noproc", None)
                target = seed
                time.sleep(0.01)
                continue
        try:
            result = fut.wait(min(timeout, deadline - time.monotonic()))
        except TimeoutError:
            last_err = ErrorResult("timeout", None)
            if hasattr(router, "forget_call"):
                router.forget_call(fut)
            break
        if isinstance(result, ErrorResult):
            last_err = result
            if result.reason == "not_leader":
                if result.leader is not None and result.leader != target:
                    target = result.leader
                else:
                    time.sleep(0.01)  # election in progress
                continue
            if result.reason in retry_reasons:
                time.sleep(0.02)
                continue
        return result
    raise TimeoutError(f"{timeout_msg}: {last_err}")


def process_command(server_id: ServerId, data: Any,
                    router: Optional[LocalRouter] = None,
                    timeout: float = 5.0,
                    reply_mode: ReplyMode = ReplyMode.AWAIT_CONSENSUS,
                    reply_from: Any = None,
                    trace_ctx: Optional[str] = None) -> Any:
    """Send a command and await consensus (ra:process_command/3 :804-828),
    following not_leader redirects like the reference's leader_call loop.

    Every command gets a causal trace context at this ingress:
    ``trace_ctx`` to supply one (a client session propagating its own),
    else a deterministic id is minted here.  The context rides the
    command object end to end; hop events land in the flight recorder
    and ``tools/ra_trace.py`` reconstructs the timeline.

    ``reply_from`` picks which member answers (the reply_from command
    option, ra.erl:786-823): None/"leader" (default), ("member", sid),
    or "local" — resolved client-side to a cluster member hosted on one
    of THIS process's nodes (falling back to the leader when none is).
    A non-leader replier needs the reply handle to reach that member's
    log copy: true for in-process routing (objects travel unpickled)
    and for TCP rcall handles (tuples survive the wire/durable image);
    recovery replays suppress reply effects everywhere regardless."""
    from .core.types import CommandEvent
    router = router or DEFAULT_ROUTER
    ctx = trace_ctx or trace.new_trace_ctx()
    record("cmd.ingress", trace=ctx, op="process_command",
           target=str(server_id))
    if reply_from == "local":
        # find ANY member of the seed's cluster hosted by one of this
        # process's nodes — the seed itself need not be local; shells
        # know their whole cluster, so a co-located sibling resolves it
        reply_from = None
        for node in router.nodes.values():
            for shell in list(node.shells.values()):
                srv = shell.server
                if server_id == srv.id or server_id in srv.cluster:
                    reply_from = ("member", srv.id)
                    break
            if reply_from is not None:
                break
    elif reply_from == "leader":
        reply_from = None
    return _leader_call(
        server_id,
        lambda fut: CommandEvent(UserCommand(data, reply_mode=reply_mode,
                                             reply_from=reply_from,
                                             trace=ctx),
                                 from_=fut),
        router, timeout, timeout_msg="ra: command not completed",
        trace_ctx=ctx)


def pipeline_command(server_id: ServerId, data: Any, correlation: Any = None,
                     notify_to: Any = None,
                     priority: Priority = Priority.LOW,
                     router: Optional[LocalRouter] = None,
                     trace_ctx: Any = None) -> None:
    """Fire-and-forget with applied-notification (ra:pipeline_command/4
    :886-896).  notify_to receives [(correlation, reply)] batches.
    Like process_command, the ingress mints (or adopts) a trace context
    that rides the command through the flight-recorder hop events —
    pass ``trace_ctx=False`` to pipeline UNTRACED (the reference's cast
    carries no tracing either): at 100k cmds/s the per-command mint +
    ingress/append/apply hop records are real budget, and a bulk
    pipeliner can opt out without touching anyone else's traces.

    ``server_id`` on a node this process hosts submits through the
    node's low-priority flush; a REMOTE member (TcpRouter reach)
    buffers through the router's pipeline fan-in and ships as
    multi-command {commands, Batch} frames — the cross-host twin of
    the node-side flush."""
    router = router or DEFAULT_ROUTER
    node = router.nodes.get(server_id.node)
    if trace_ctx is False:
        ctx = None
    else:
        ctx = trace_ctx or trace.new_trace_ctx()
        record("cmd.ingress", trace=ctx, op="pipeline_command",
               target=str(server_id))
    cmd = UserCommand(data, reply_mode=ReplyMode.NOTIFY,
                      correlation=correlation, notify_to=notify_to,
                      trace=ctx)
    if node is None:
        cast = getattr(router, "pipeline_cast", None)
        if cast is None:
            raise RuntimeError(f"node {server_id.node} is not running")
        cast(server_id, cmd)
        return
    node.submit_command(server_id.name, cmd, None, priority=priority)


def pipeline_commands(server_id: ServerId, items: list,
                      notify_to: Any = None,
                      priority: Priority = Priority.LOW,
                      router: Optional[LocalRouter] = None,
                      trace_ctx: Any = False) -> None:
    """Burst twin of pipeline_command: ``items`` is
    ``[(data, correlation), ...]``, all notify-mode toward one
    ``notify_to``.  The whole burst pays ONE ingress call, one router
    lock cycle, and (cross-host) one pipeline-buffer submission —
    at pipelined rates the per-command pipeline_command round spends
    more time in call/lock/wake overhead than in the work itself, and
    that overhead lands on the same core budget as the measured plane.
    Untraced by default (the bulk-pipeliner opt-out documented on
    pipeline_command); pass ``trace_ctx=None`` to mint per-command
    contexts."""
    from .codec import build_user
    router = router or DEFAULT_ROUTER
    node = router.nodes.get(server_id.node)
    if trace_ctx is False:
        cmds = [build_user(data, ReplyMode.NOTIFY, corr, notify_to,
                           None, None) for data, corr in items]
    else:
        cmds = []
        for data, corr in items:
            ctx = trace_ctx or trace.new_trace_ctx()
            record("cmd.ingress", trace=ctx, op="pipeline_command",
                   target=str(server_id))
            cmds.append(build_user(data, ReplyMode.NOTIFY, corr,
                                   notify_to, None, None, ctx))
    if node is None:
        cast_many = getattr(router, "pipeline_cast_many", None)
        if cast_many is not None:
            cast_many(server_id, cmds)
            return
        cast = getattr(router, "pipeline_cast", None)
        if cast is None:
            raise RuntimeError(f"node {server_id.node} is not running")
        for cmd in cmds:
            cast(server_id, cmd)
        return
    node.submit_commands(server_id.name, cmds, priority=priority)


def ping(server_id: ServerId,
         router: Optional[LocalRouter] = None) -> tuple:
    """Local liveness probe: ("pong", raft_state) for a member hosted
    on THIS process's router (the ra_server_proc:ping role, :238-240).
    Like local_query/key_metrics, this reads the shell directly and
    does not reach members on remote nodes — probe those from their own
    node (the per-node ops model the TCP workers use)."""
    router = router or DEFAULT_ROUTER
    node = _node_of(server_id, router)
    shell = node.shells.get(server_id.name)
    if shell is None:
        raise RuntimeError(f"no such server {server_id}")
    return ("pong", shell.server.raft_state.value)


def local_query(server_id: ServerId, query_fn: Callable,
                router: Optional[LocalRouter] = None,
                condition: Any = None, timeout: float = 5.0) -> Any:
    """Query this member's machine state directly (ra:local_query :962).

    ``condition=("applied", (idx, term))`` delays evaluation until this
    member has applied at least idx with a matching term (the
    query_condition option, ra.erl:115-131 — read-your-writes on a
    follower); raises TimeoutError if the condition never holds, and
    returns an ErrorResult if idx was applied under a DIFFERENT term
    (the awaited entry was overwritten)."""
    router = router or DEFAULT_ROUTER
    node = _node_of(server_id, router)
    shell = node.shells.get(server_id.name)
    if shell is None:
        raise RuntimeError(f"no such server {server_id}")
    srv = shell.server
    if condition is not None:
        kind, (idx, term) = condition
        if kind != "applied":
            raise ValueError(f"unknown query condition {kind!r}")
        deadline = time.monotonic() + timeout
        while srv.last_applied < idx:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ra: local_query condition applied>={idx} not met "
                    f"(at {srv.last_applied})")
            time.sleep(0.005)
        actual = srv.log.fetch_term(idx)
        if actual is not None and term is not None and actual != term:
            return ErrorResult("condition_term_mismatch", srv.leader_id)
    node.counters.incr(srv.cfg.uid, "local_queries")
    return CommandResult(srv.last_applied, srv.current_term,
                         query_fn(srv.machine_state), srv.leader_id)


def leader_query(any_member: ServerId, query_fn: Callable,
                 router: Optional[LocalRouter] = None,
                 timeout: float = 5.0) -> Any:
    """Query the leader's machine state (ra:leader_query :1012)."""
    router = router or DEFAULT_ROUTER
    leader = _await_leader(any_member, router, timeout)
    return local_query(leader, query_fn, router)


def consistent_query(server_id: ServerId, query_fn: Callable,
                     router: Optional[LocalRouter] = None,
                     timeout: float = 5.0) -> Any:
    """Linearizable read via heartbeat quorum (ra:consistent_query :1051,
    core machinery ra_server.erl:3032-3190)."""
    router = router or DEFAULT_ROUTER
    return _leader_call(
        server_id,
        lambda fut: ConsistentQueryEvent(query_fn, from_=fut),
        router, timeout, timeout_msg="ra: consistent_query timed out")


def members(server_id: ServerId,
            router: Optional[LocalRouter] = None) -> list:
    router = router or DEFAULT_ROUTER
    node = _node_of(server_id, router)
    shell = node.shells.get(server_id.name)
    if shell is None:
        raise RuntimeError(f"no such server {server_id}")
    return list(shell.server.cluster.keys())


def members_info(server_id: ServerId,
                 router: Optional[LocalRouter] = None,
                 timeout: float = 5.0) -> dict:
    """Per-member replication detail (ra:members_info/1 :1108,
    state_query(members_info), ra_server.erl:2422-2466).  Resolved
    against the LEADER's peer table: match/next/query index, status,
    and membership per member; a follower target is first redirected
    like any leader call."""
    router = router or DEFAULT_ROUTER
    leader = _await_leader(server_id, router, timeout)
    node = _node_of(leader, router)
    shell = node.shells.get(leader.name)
    if shell is None:
        raise RuntimeError(f"no such server {leader}")
    srv = shell.server
    out: dict = {}
    for sid, peer in srv.cluster.items():
        if sid == srv.id:
            out[sid] = {
                "match_index": srv.commit_index,
                "next_index": srv.commit_index + 1,
                "query_index": srv.query_index,
                "status": "normal",
                "membership": srv.membership.value,
            }
        else:
            out[sid] = {
                "match_index": peer.match_index,
                "next_index": peer.next_index,
                "query_index": peer.query_index,
                "status": peer.status.value,
                "membership": peer.membership.value,
            }
    return out


def add_member(server_id: ServerId, new_member: ServerId,
               membership: Membership = Membership.VOTER,
               router: Optional[LocalRouter] = None,
               timeout: float = 5.0) -> Any:
    """One-at-a-time join ('$ra_join', ra.erl:593-602).  The new member's
    server must be started separately (ra:start_server then add_member)."""
    router = router or DEFAULT_ROUTER
    return _member_change(server_id, JoinCommand(new_member, membership),
                          router, timeout)


def remove_member(server_id: ServerId, old_member: ServerId,
                  router: Optional[LocalRouter] = None,
                  timeout: float = 5.0) -> Any:
    router = router or DEFAULT_ROUTER
    return _member_change(server_id, LeaveCommand(old_member), router,
                          timeout)


def _member_change(server_id: ServerId, cmd: Any, router: LocalRouter,
                   timeout: float) -> Any:
    from .core.types import CommandEvent
    return _leader_call(
        server_id, lambda fut: CommandEvent(cmd, from_=fut), router, timeout,
        retry_reasons=("cluster_change_not_permitted",),
        timeout_msg="ra: member change timed out")


def delete_cluster(server_id: ServerId,
                   router: Optional[LocalRouter] = None,
                   timeout: float = 5.0) -> Any:
    """Orderly cluster teardown ('$ra_cluster' delete, ra.erl:556)."""
    router = router or DEFAULT_ROUTER
    from .core.types import CommandEvent
    return _leader_call(
        server_id,
        lambda fut: CommandEvent(ClusterDeleteCommand(), from_=fut),
        router, timeout, timeout_msg="ra: delete_cluster timed out")


def trigger_election(server_id: ServerId,
                     router: Optional[LocalRouter] = None) -> None:
    router = router or DEFAULT_ROUTER
    node = router.nodes.get(server_id.node)
    if node is not None:
        node.submit(server_id.name, ForceElectionEvent())
        return
    # remote member: the event travels the data plane like any RPC
    if not router.send("?", server_id, ForceElectionEvent()):
        raise RuntimeError(
            f"trigger_election: {server_id} is unreachable")


def force_shrink_members_to_current_member(
        server_id: ServerId,
        router: Optional[LocalRouter] = None,
        timeout: float = 5.0) -> Any:
    """Disaster recovery: shrink ``server_id``'s cluster to itself and
    self-elect (ra_server_proc:force_shrink_members_to_current_member,
    :234-236).  For permanent majority loss ONLY — the surviving member
    unilaterally rewrites membership, so using it while the others are
    merely partitioned manufactures split-brain.  Raises if the member
    refuses (e.g. it is parked in await_condition behind a dead WAL —
    an operator must never mistake a refused escape hatch for a
    successful one)."""
    router = router or DEFAULT_ROUTER
    node = _node_of(server_id, router)
    fut = Future()
    if not node.submit(server_id.name, ForceMemberChangeEvent(from_=fut)):
        raise RuntimeError(f"force_shrink: no such server {server_id} "
                           "(noproc)")
    result = fut.wait(timeout)
    if isinstance(result, ErrorResult):
        raise RuntimeError(
            f"force_shrink refused by {server_id}: {result.reason}")
    return result


def transfer_leadership(server_id: ServerId, target: ServerId,
                        router: Optional[LocalRouter] = None,
                        timeout: float = 5.0) -> Any:
    router = router or DEFAULT_ROUTER
    leader = _await_leader(server_id, router, timeout)
    node = _node_of(leader, router)
    fut = Future()
    node.submit(leader.name, TransferLeadershipEvent(target, from_=fut))
    return fut.wait(timeout)


def _await_leader(seed: ServerId, router: LocalRouter,
                  timeout: float) -> ServerId:
    """Resolve the current leader, polling through elections."""
    deadline = time.monotonic() + timeout
    target = seed
    while time.monotonic() < deadline:
        node = router.nodes.get(target.node)
        shell = node.shells.get(target.name) if node else None
        if shell is not None:
            srv = shell.server
            if srv.raft_state == srv.raft_state.LEADER:
                return target
            if srv.leader_id is not None:
                if srv.leader_id == target:
                    return target
                target = srv.leader_id
                continue
        time.sleep(0.01)
    raise TimeoutError(f"ra: no leader found via {seed}")


def aux_command(server_id: ServerId, cmd: Any,
                router: Optional[LocalRouter] = None,
                timeout: float = 5.0) -> Any:
    """Route a command to the machine's handle_aux on a specific member
    (ra:aux_command)."""
    from .core.types import AuxCommandEvent
    router = router or DEFAULT_ROUTER
    node = _node_of(server_id, router)
    fut = Future()
    if not node.submit(server_id.name, AuxCommandEvent(cmd, from_=fut)):
        raise RuntimeError(f"no such server {server_id}")
    return fut.wait(timeout)


def cast_aux_command(server_id: ServerId, cmd: Any,
                     router: Optional[LocalRouter] = None) -> None:
    from .core.types import AuxCommandEvent
    router = router or DEFAULT_ROUTER
    node = _node_of(server_id, router)
    node.submit(server_id.name, AuxCommandEvent(cmd))


def member_overview(server_id: ServerId,
                    router: Optional[LocalRouter] = None) -> dict:
    """Full state dump of one member (ra:member_overview)."""
    router = router or DEFAULT_ROUTER
    node = _node_of(server_id, router)
    shell = node.shells.get(server_id.name)
    if shell is None:
        return {"state": "noproc"}
    return shell.server.overview()


def overview(router: Optional[LocalRouter] = None) -> dict:
    """Node-level overview across all local RaNodes (ra:overview), plus
    process-wide io metrics (the ra_io_metrics ETS role).

    Shape: ``{"nodes": {node_name: node_overview}, "io": io_stats}``.
    NOTE: before round 1's io-stats addition this returned the node map at
    top level; callers iterating node names must use ``overview()["nodes"]``.
    """
    from .native import IO

    router = router or DEFAULT_ROUTER
    return {
        "nodes": {name: node.overview()
                  for name, node in router.nodes.items()},
        "io": IO.stats(),
    }


def key_metrics(server_id: ServerId,
                router: Optional[LocalRouter] = None) -> dict:
    """Read metrics without touching the server's event loop
    (ra:key_metrics :1229-1257)."""
    router = router or DEFAULT_ROUTER
    node = _node_of(server_id, router)
    shell = node.shells.get(server_id.name)
    if shell is None:
        return {"state": "noproc"}
    srv = shell.server
    last = srv.log.last_index_term()
    lw = srv.log.last_written()
    # counters = shell fields + core stats + log-subsystem fields, the
    # flat union the reference samples from its single counter array
    counters = dict(node.counters.fetch(srv.cfg.uid) or {})
    counters.update(srv.stats)
    log_metrics = getattr(srv.log, "log_metrics", None)
    if log_metrics is not None:
        counters.update(log_metrics())
    checkpoint_index = getattr(srv.log, "checkpoint_index", lambda: 0)()
    return {
        "state": srv.raft_state.value,
        "raft_state": srv.raft_state.value,
        "leader": srv.leader_id,
        "term": srv.current_term,
        "commit_index": srv.commit_index,
        "last_applied": srv.last_applied,
        "last_index": last.index,
        "last_written_index": lw.index,
        "snapshot_index": srv.log.snapshot_index_term().index,
        "checkpoint_index": checkpoint_index,
        "commit_latency": srv.commit_latency,
        "commit_latency_ms": srv.commit_latency * 1000.0,
        "machine_version": srv.machine_version,
        "effective_machine_version": srv.effective_machine_version,
        "membership": srv.membership.value,
        "counters": counters,
    }
