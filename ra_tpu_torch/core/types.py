"""Core wire/state types of the classic plane (the port's own copy of
``ra_tpu/core/types.py``).

Message families mirror the reference protocol records
(ra.hrl:111-188): append_entries_rpc, append_entries_reply,
request_vote_rpc/result, pre_vote_rpc/result, install_snapshot_rpc/result,
heartbeat_rpc/reply.  Commands and reply modes mirror ra_server:command_type()
and ra_server:command_reply_mode() (ra_server.erl:100-140).

These are plain frozen dataclasses: the pure core consumes and produces them as
data.  The batched lane engine (ra_tpu_torch.ops / ra_tpu_torch.engine) re-encodes
the hot subset (AER replies, votes, heartbeats) into SoA integer arrays for
its quorum kernels; these dataclasses remain the lingua franca of the host paths
(transport, log, tests).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Union

# protocol version gate, exchanged in pre-vote only (ra.hrl:96-108)
RA_PROTO_VERSION = 1


class ServerId(NamedTuple):
    """{Name, Node} pair identifying one cluster member (ra:server_id())."""

    name: str
    node: str

    def __repr__(self) -> str:  # compact, log-friendly
        return f"{self.name}@{self.node}"


# ---------------------------------------------------------------------------
# Index/term bookkeeping
# ---------------------------------------------------------------------------

class IdxTerm(NamedTuple):
    index: int
    term: int


SNAPSHOT_NONE = IdxTerm(0, 0)  # "no entry"; log indexes are 1-based like ra


# ---------------------------------------------------------------------------
# Raft states (ra_server:ra_state(), ra_server.erl:142-150)
# ---------------------------------------------------------------------------

class RaftState(str, enum.Enum):
    LEADER = "leader"
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    PRE_VOTE = "pre_vote"
    AWAIT_CONDITION = "await_condition"
    RECEIVE_SNAPSHOT = "receive_snapshot"
    RECOVER = "recover"
    RECOVERED = "recovered"
    STOP = "stop"
    DELETE_AND_TERMINATE = "delete_and_terminate"


class Membership(str, enum.Enum):
    """Voting status of a member (ra:ra_membership())."""

    VOTER = "voter"
    NON_VOTER = "non_voter"
    PROMOTABLE = "promotable"  # non-voter that auto-promotes at target index
    UNKNOWN = "unknown"


class PeerStatus(str, enum.Enum):
    """Per-peer replication status (ra.hrl:51-54)."""

    NORMAL = "normal"
    SENDING_SNAPSHOT = "sending_snapshot"
    SUSPENDED = "suspended"
    DISCONNECTED = "disconnected"


# ---------------------------------------------------------------------------
# Commands
# ---------------------------------------------------------------------------

class ReplyMode(str, enum.Enum):
    """When/how the caller learns about its command (ra_server.erl:117-131)."""

    AFTER_LOG_APPEND = "after_log_append"
    AWAIT_CONSENSUS = "await_consensus"
    NOTIFY = "notify"  # carries (correlation, pid) in the command
    NOREPLY = "noreply"


class Priority(str, enum.Enum):
    NORMAL = "normal"
    LOW = "low"


@dataclass(frozen=True, slots=True)
class UserCommand:
    """'$usr' — a command for the user state machine.

    ``slots=True`` because this is the highest-volume object on the
    classic plane: one instance per client command, created on the
    ingress path at up-to-100k/s rates — the slotted form
    drops per-instance dict allocation from the hot path."""

    data: Any
    reply_mode: ReplyMode = ReplyMode.AWAIT_CONSENSUS
    correlation: Any = None  # used with ReplyMode.NOTIFY
    notify_to: Any = None    # destination for applied-notifications
    from_: Any = None        # reply destination, attached at append time
    #: which member answers an await_consensus call: None/"leader", or
    #: ("member", ServerId) — the reply_from command option
    #: (ra.erl:786-823); useful when the caller sits nearer a follower
    reply_from: Any = None
    #: causal trace context minted at ingress: a short string
    #: id that rides the command through append/replication/WAL/apply
    #: so the flight recorder's hop events join into one timeline.
    #: None = untraced (the cost of the disabled path is one
    #: ``is not None`` test per hop).
    trace: Any = None

    kind = "usr"


@dataclass(frozen=True)
class NoopCommand:
    """'$noop' appended by a new leader; carries effective machine version
    (ra_server.erl:839-859, applied at :2671-2731)."""

    machine_version: int

    kind = "noop"


@dataclass(frozen=True)
class JoinCommand:
    """'$ra_join' — add a member (ra.erl:593-602)."""

    server_id: ServerId
    membership: Membership = Membership.VOTER
    reply_mode: ReplyMode = ReplyMode.AWAIT_CONSENSUS
    from_: Any = None

    kind = "ra_join"


@dataclass(frozen=True)
class LeaveCommand:
    """'$ra_leave' — remove a member (ra.erl:628)."""

    server_id: ServerId
    reply_mode: ReplyMode = ReplyMode.AWAIT_CONSENSUS
    from_: Any = None

    kind = "ra_leave"


@dataclass(frozen=True)
class ClusterDeleteCommand:
    """'$ra_cluster' delete — orderly cluster teardown (ra.erl:556)."""

    reply_mode: ReplyMode = ReplyMode.AWAIT_CONSENSUS
    from_: Any = None

    kind = "ra_cluster_delete"


@dataclass(frozen=True)
class ClusterChangeCommand:
    """'$ra_cluster_change' — the full new cluster, appended by the leader
    when it processes a join/leave (ra_server.erl:2798-2915).  ``cluster`` is
    a tuple of (ServerId, Membership) pairs — the complete new membership."""

    cluster: tuple
    reply_mode: ReplyMode = ReplyMode.AWAIT_CONSENSUS
    correlation: Any = None
    notify_to: Any = None
    from_: Any = None

    kind = "ra_cluster_change"


Command = Union[UserCommand, NoopCommand, JoinCommand, LeaveCommand,
                ClusterChangeCommand, ClusterDeleteCommand]


class Entry(NamedTuple):
    """One log entry: {Index, Term, Command} (ra:log_entry())."""

    index: int
    term: int
    command: Command


# ---------------------------------------------------------------------------
# RPC message families (ra.hrl:111-188)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AppendEntriesRpc:
    term: int
    leader_id: ServerId
    prev_log_index: int
    prev_log_term: int
    leader_commit: int
    entries: tuple = ()  # tuple[Entry, ...]
    #: OPTIONAL encoded durable images parallel to ``entries`` : the leader already holds each entry's WAL payload bytes in
    #: its memtable, and shipping them lets followers feed their WAL
    #: without re-encoding (the batch-append path skips one pickle per
    #: entry per follower).  None when the leader's bytes are gone
    #: (segment-flushed catch-up) — followers then encode themselves.
    payloads: Optional[tuple] = None


@dataclass(frozen=True)
class AppendEntriesReply:
    term: int
    success: bool
    # ra's reply carries next_index + last matched idx/term rather than a
    # simple conflict index (ra.hrl:127-137)
    next_index: int
    last_index: int
    last_term: int
    from_: ServerId = None  # filled by transport/shell when routing


@dataclass(frozen=True)
class RequestVoteRpc:
    term: int
    candidate_id: ServerId
    last_log_index: int
    last_log_term: int


@dataclass(frozen=True)
class RequestVoteResult:
    term: int
    vote_granted: bool
    from_: ServerId = None


@dataclass(frozen=True)
class PreVoteRpc:
    term: int
    token: Any
    candidate_id: ServerId
    version: int  # protocol version, gated here only (ra.hrl:96-108)
    machine_version: int
    last_log_index: int
    last_log_term: int


@dataclass(frozen=True)
class PreVoteResult:
    term: int
    token: Any
    vote_granted: bool
    from_: ServerId = None


@dataclass(frozen=True)
class SnapshotMeta:
    """Snapshot metadata (ra_snapshot:meta())."""

    index: int
    term: int
    cluster: tuple  # tuple[(ServerId, Membership), ...]
    machine_version: int


@dataclass(frozen=True)
class InstallSnapshotRpc:
    term: int
    leader_id: ServerId
    meta: SnapshotMeta
    chunk_number: int
    chunk_flag: str  # "next" | "last"
    data: bytes
    #: crc32 of ``data`` — validated per chunk on accept so a corrupt
    #: transfer aborts early instead of poisoning the assembled snapshot
    #: (ra_log_snapshot.erl:73-111); -1 = absent (old peers)
    chunk_crc: int = -1
    #: transfer identity, echoed in the result so the leader can reject
    #: stragglers from an abandoned (timed-out) transfer
    token: Any = None


@dataclass(frozen=True)
class InstallSnapshotResult:
    term: int
    last_index: int
    last_term: int
    from_: ServerId = None
    token: Any = None  # echoes InstallSnapshotRpc.token


@dataclass(frozen=True)
class HeartbeatRpc:
    """Consistent-query heartbeat (ra.hrl:176-188)."""

    query_index: int
    term: int
    leader_id: ServerId


@dataclass(frozen=True)
class HeartbeatReply:
    query_index: int
    term: int
    from_: ServerId = None


RaMsg = Union[AppendEntriesRpc, AppendEntriesReply, RequestVoteRpc,
              RequestVoteResult, PreVoteRpc, PreVoteResult,
              InstallSnapshotRpc, InstallSnapshotResult,
              HeartbeatRpc, HeartbeatReply]


# ---------------------------------------------------------------------------
# Non-RPC events fed to the core by the shell
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ElectionTimeout:
    pass


@dataclass(frozen=True)
class CommandEvent:
    """A client command arriving at this server ({command, Priority, Cmd})."""

    command: Command
    priority: Priority = Priority.NORMAL
    from_: Any = None  # reply destination for call-style commands


@dataclass(frozen=True)
class CommandsEvent:
    """Flushed batch of low-priority commands ({commands, Cmds}).

    ``images`` optionally carries the commands' codec payload
    images, aligned 1:1 with ``commands``: a batch that arrived over the
    wire was already encoded ONCE at the client, so the leader appends
    the shipped bytes (and a follower relays them) instead of
    re-encoding — the encode-once contract of ra_tpu_torch.codec."""

    commands: tuple
    images: Optional[tuple] = None


@dataclass(frozen=True)
class WrittenEvent:
    """{ra_log_event, {written, Term, {From, To}}} from the WAL."""

    from_index: int
    to_index: int
    term: int


@dataclass(frozen=True)
class LogEvent:
    """Other ra_log_event payloads routed into the log facade."""

    payload: Any


@dataclass(frozen=True)
class WalUpEvent:
    """The WAL was restarted after a crash: cores parked in
    await_condition(wal_down) may resume (the new-wal-pid signal a
    reference server observes via ra_log, ra_log.erl:778-793)."""

    generation: int = 0


@dataclass(frozen=True)
class DownEvent:
    """Process-down notification (monitor fired)."""

    target: Any
    reason: Any = None


@dataclass(frozen=True)
class UpEvent:
    """Process-up notification: a co-hosted member (re)started.  The
    DownEvent twin for the in-process deployment: a kill
    broadcast DownEvent to co-hosted siblings — the leader marked the
    peer DISCONNECTED and stopped replicating to it — but a restart
    had no up edge, so a restarted follower with a shorter log wedged
    forever (it cannot win pre-votes, and the leader never resumes its
    catch-up).  Cross-node deployments heal through the transport
    failure detector's NodeEvent("up"); this is the same verdict at
    member granularity for siblings that share a node."""

    target: Any


@dataclass(frozen=True)
class NodeEvent:
    """Failure-detector verdict for a node: up | down."""

    node: str
    status: str


@dataclass(frozen=True)
class TickEvent:
    """Periodic maintenance tick (ra_server:tick/1)."""

    pass


@dataclass(frozen=True)
class ConsistentQueryEvent:
    query_fn: Any
    from_: Any = None


@dataclass(frozen=True)
class TransferLeadershipEvent:
    target: ServerId
    from_: Any = None


@dataclass(frozen=True)
class ForceMemberChangeEvent:
    """Disaster-recovery escape hatch: shrink the cluster to THIS member
    only, then self-elect — used when a permanent majority outage makes
    normal membership changes impossible
    (force_shrink_members_to_current_member,
    ra_server_proc.erl:234-236, ra_server.erl:1320-1328)."""

    from_: Any = None


@dataclass(frozen=True)
class ForceElectionEvent:
    """trigger_election — skip pre-vote, go straight to candidate."""

    pass


@dataclass(frozen=True)
class AuxCommandEvent:
    """{aux_command, Type, Cmd} — routed to the machine's handle_aux
    (ra.erl aux_command/cast_aux_command)."""

    cmd: Any
    from_: Any = None


#: reserved server name addressing a NODE's control plane rather than a
#: member (the rpc:call target role of ra_server_sup_sup.erl:42-130)
NODE_SCOPE = "$node"


@dataclass(frozen=True)
class NodeControlEvent:
    """Node-lifecycle RPC: start/restart/stop/force-delete a member on
    the receiving node (ra_server_sup_sup's start_server_rpc /
    restart_server_rpc / prepare_server_stop_rpc).  Picklable — args
    carry config snapshots and machine SPECS, never live objects."""

    op: str
    args: dict
    from_: Any = None


# ---------------------------------------------------------------------------
# Effects — returned by the pure core / machine, executed by the shell
# (ra_machine.erl:121-142 + ra_server internal effects)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SendRpc:
    """Async cast to a peer; must never block (ra_server_proc.erl:1317-1341)."""

    to: ServerId
    msg: RaMsg


@dataclass(frozen=True)
class SendVoteRequests:
    """Fan-out vote/pre-vote requests in parallel (ra_server_proc.erl:1495)."""

    requests: tuple  # tuple[(ServerId, RaMsg), ...]


@dataclass(frozen=True)
class Reply:
    """Reply to a synchronous caller.

    ``replier`` picks WHICH member sends it ({reply, From, Reply,
    Replier}, ra_server.erl:2771-2781): "leader" (default — follower
    copies are filtered) or ("member", ServerId) — every member emits
    the effect, the shell executes it only on the named member.  The
    reply value is deterministic across replicas, so any member's copy
    is THE reply."""

    to: Any
    msg: Any
    replier: Any = "leader"


@dataclass(frozen=True)
class NextEvent:
    """Re-inject an event into the core immediately."""

    event: Any


@dataclass(frozen=True)
class SendMsg:
    """Machine effect: send an arbitrary message (ra_machine.erl:121-127).
    options: as_ra_event / cast / local."""

    to: Any
    msg: Any
    options: tuple = ()


@dataclass(frozen=True)
class AppendEffect:
    """{append, Cmd} / {append, Cmd, ReplyMode} machine effect
    (ra_machine.erl:128-130): the machine asks the LEADER to append a
    follow-up user command from apply/3.  Executed by re-entering the
    command path (ra_server_proc.erl:1377-1382); followers drop it
    (filter_follower_effects — only the leader originates the append,
    every member then applies it through normal replication)."""

    data: Any
    reply_mode: "ReplyMode" = None  # None -> noreply
    correlation: Any = None         # for ReplyMode.NOTIFY
    notify_to: Any = None


@dataclass(frozen=True)
class ModCall:
    fn: Any
    args: tuple = ()


@dataclass(frozen=True)
class Notify:
    """Applied-notification batch: {applied, [{Correlation, Reply}]}."""

    to: Any
    correlations: tuple  # tuple[(correlation, reply), ...]


@dataclass(frozen=True)
class Monitor:
    kind: str  # "process" | "node"
    target: Any
    component: str = "machine"  # machine|aux|snapshot_sender|snapshot_writer|log


@dataclass(frozen=True)
class Demonitor:
    kind: str
    target: Any
    component: str = "machine"


@dataclass(frozen=True)
class TimerEffect:
    name: Any
    ms: Optional[int]  # None cancels
    msg: Any = None


@dataclass(frozen=True)
class LogReadEffect:
    """Machine effect {log, Indexes, Fun[, {local, Node}]}: read back
    committed entries (ra_machine.erl:136-137).

    Reference parity: the BARE effect executes on EVERY member that
    applies the command (filter_follower_effects keeps it,
    ra_server.erl:1837-1838; executed in any raft state,
    ra_server_proc.erl:1383-1397) — the fn must be idempotent or
    deduplicate via its closure.  ``local`` restricts execution to the
    named node (the {local, Node} option, :1369-1376).  Effects
    returned by fn are executed in place (the reference's recursion)."""

    indexes: tuple
    fn: Any
    local: Any = None  # node name, or None = every member


@dataclass(frozen=True)
class ReleaseCursor:
    """Machine effect: log can be truncated up to index; snapshot state."""

    index: int
    machine_state: Any


@dataclass(frozen=True)
class Checkpoint:
    """Machine effect: cheap state dump that does NOT truncate the log."""

    index: int
    machine_state: Any


@dataclass(frozen=True)
class PromoteCheckpoint:
    index: int


@dataclass(frozen=True)
class AuxEffect:
    msg: Any


@dataclass(frozen=True)
class GarbageCollection:
    pass


@dataclass(frozen=True)
class StartElectionTimeout:
    """Shell should (re)arm the election timer (ra_server_proc.erl:1638-1657)."""

    kind: str = "medium"  # really_short | short | medium | long


@dataclass(frozen=True)
class CancelElectionTimeout:
    pass


@dataclass(frozen=True)
class SendSnapshot:
    """Leader side: spawn a chunked snapshot send to peer
    (ra_server_proc.erl:1446-1488)."""

    to: ServerId
    id_term: tuple  # (leader_id, term)
    token: Any = None  # transfer identity (stamped on the peer)


@dataclass(frozen=True)
class RecordLeader:
    """Leaderboard update: cluster name -> (leader, members)."""

    cluster_name: str
    leader: Optional[ServerId]
    members: tuple


@dataclass(frozen=True)
class IncrementMetric:
    name: str
    amount: int = 1


Effect = Any  # union of the above; kept open for machine-defined effects

Effects = list  # list[Effect]


# ---------------------------------------------------------------------------
# Replies sent back to clients by the shell
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CommandResult:
    """Successful command outcome: {ok, Reply, Leader}."""

    index: int
    term: int
    reply: Any = None  # None for after_log_append acks
    leader: Optional[ServerId] = None


@dataclass(frozen=True)
class ErrorResult:
    reason: Any
    leader: Optional[ServerId] = None


def strip_local_handles(cmd: Any) -> Any:
    """Drop process-local reply handles (futures/callables) from a command
    before it leaves the process (wire or disk).  Replies are only ever
    owed by the member that accepted the call; remote/recovered copies
    never fire them (recovery replays with effects suppressed,
    ra_server.erl:376-414)."""
    from dataclasses import replace as _replace
    out = cmd
    for field_ in ("from_", "notify_to"):
        v = getattr(out, field_, None)
        if v is not None and not isinstance(v, (str, int, tuple)):
            out = _replace(out, **{field_: None})
    return out


def strip_msg_handles(msg: Any) -> Any:
    """Sanitize an outbound RPC: AER entries may embed commands carrying
    local reply handles."""
    if isinstance(msg, AppendEntriesRpc) and msg.entries:
        from dataclasses import replace as _replace
        entries = tuple(
            Entry(e.index, e.term, strip_local_handles(e.command))
            for e in msg.entries)
        return _replace(msg, entries=entries)
    return msg


# ---------------------------------------------------------------------------
# Server configuration (ra_server:ra_server_config(), ra_server.erl:188-213)
# ---------------------------------------------------------------------------

#: tunables persisted in (and restored from) the directory's config
#: snapshot beyond the always-present identity/timing fields — ONE list
#: shared by the snapshot writer and both restore sites, so adding a
#: tunable cannot silently stop round-tripping through recovery
SNAPSHOT_TUNABLE_KEYS = (
    "await_condition_timeout_ms", "max_pipeline_count",
    "max_append_entries_batch", "max_append_entries_bytes",
    "command_flush_size", "snapshot_chunk_size",
    "install_snap_rpc_timeout_ms", "friendly_name",
)


@dataclass
class ServerConfig:
    server_id: ServerId
    uid: str
    cluster_name: str
    initial_members: tuple  # tuple[ServerId, ...]
    machine: Any  # Machine instance (ra_tpu_torch.core.machine.Machine)
    log_init_args: dict = field(default_factory=dict)
    # election tuning (ms); shell maps StartElectionTimeout kinds onto these
    broadcast_time_ms: int = 100
    election_timeout_ms: int = 1000
    tick_interval_ms: int = 1000
    await_condition_timeout_ms: int = 3000
    max_pipeline_count: int = 4096   # ra_server.hrl:7
    #: entries per AppendEntries frame.  The reference ships 128
    #: (ra_server.hrl:8); with the batch-native follower path (ONE
    #: append + ONE WAL fan-in submit + ONE cumulative reply per
    #: frame) deeper frames amortize strictly further, so
    #: the default rides the byte bound below instead
    max_append_entries_batch: int = 1024
    #: byte bound on one AppendEntries frame: a batch closes
    #: when EITHER the entry cap or this payload-byte budget is reached
    #: (evaluated against the encoded durable images when the leader
    #: holds them), so a burst of large commands cannot build a frame
    #: that stalls the socket behind one send
    max_append_entries_bytes: int = 1 << 20
    #: how many buffered low-priority commands flush into one
    #: {commands, Batch} event.  The reference's
    #: ?FLUSH_COMMANDS_SIZE is 16 (ra_server.hrl:11); the batch-native
    #: append path amortizes its one-lock/one-WAL-submit cost over the
    #: whole event, so a deeper default flush is strictly cheaper until
    #: frames hit max_append_entries_* bounds (512 measured best on the
    #: classic bench; 1024 starts trading latency for nothing)
    command_flush_size: int = 512
    snapshot_chunk_size: int = 1024 * 1024  # ra_server.hrl:9
    install_snap_rpc_timeout_ms: int = 30_000
    membership: Membership = Membership.VOTER
    friendly_name: Optional[str] = None
    counters: Any = None
    system_name: str = "default"
