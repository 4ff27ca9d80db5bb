"""Pure Raft core — the ra_server equivalent.

This is the host-side *oracle* implementation of the per-cluster Raft state
machine: every transition mirrors the semantics of
ra_server.erl (cited per-function below) but is written
as a Python class whose handlers are ``(event) -> effects`` with the next
Raft state recorded in ``self.raft_state``.  Side effects are **data**
(ra_tpu_torch.core.types effect dataclasses) executed by the shell
(``ra_tpu_torch.node``) — the same purity contract as the reference,
which is what lets the hot arithmetic (quorum evaluation, vote counting,
heartbeat quorum) also be implemented as batched kernels in ra_tpu_torch.ops:
the lane engine keeps thousands of these cores' *hot fields* in SoA arrays
and uses this class only for rare/divergent transitions and as the
conformance oracle for kernel tests.

Design note: nothing in this module performs I/O or blocks.  The
log is an injected object with memtable semantics; durability is observed
only through WrittenEvent messages, so a leader's own fsync participates in
the commit quorum exactly like a follower's reply (ra_server.erl:2977-2993).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

from ..blackbox import record
from .machine import ApplyMeta, Machine
from .types import (
    RA_PROTO_VERSION,
    AppendEffect,
    AppendEntriesReply,
    AppendEntriesRpc,
    AuxCommandEvent,
    AuxEffect,
    CancelElectionTimeout,
    Checkpoint,
    ClusterChangeCommand,
    ClusterDeleteCommand,
    CommandEvent,
    CommandsEvent,
    CommandResult,
    ConsistentQueryEvent,
    DownEvent,
    ElectionTimeout,
    Entry,
    ErrorResult,
    ForceElectionEvent,
    ForceMemberChangeEvent,
    GarbageCollection,
    HeartbeatReply,
    HeartbeatRpc,
    IdxTerm,
    InstallSnapshotResult,
    InstallSnapshotRpc,
    JoinCommand,
    LeaveCommand,
    LogReadEffect,
    Membership,
    Monitor,
    NextEvent,
    NodeEvent,
    NoopCommand,
    Notify,
    PeerStatus,
    PreVoteResult,
    PreVoteRpc,
    PromoteCheckpoint,
    RaftState,
    RecordLeader,
    ReleaseCursor,
    Reply,
    ReplyMode,
    RequestVoteResult,
    RequestVoteRpc,
    SendMsg,
    SendRpc,
    SendSnapshot,
    SendVoteRequests,
    ServerConfig,
    ServerId,
    SnapshotMeta,
    StartElectionTimeout,
    TickEvent,
    TransferLeadershipEvent,
    UpEvent,
    UserCommand,
    WalUpEvent,
    WrittenEvent,
)


@dataclass
class Peer:
    """Per-peer replication state (ra.hrl:62-73, new_peer ra_server.erl:3006)."""

    next_index: int = 1
    match_index: int = 0
    commit_index_sent: int = 0
    query_index: int = 0
    status: PeerStatus = PeerStatus.NORMAL
    membership: Membership = Membership.VOTER
    promote_target: int = 0  # promotable non-voter: target index
    snapshot_sender: Any = None  # token of in-flight snapshot send
    snapshot_started: float = 0.0  # when SENDING_SNAPSHOT was entered


@dataclass
class Condition:
    """await_condition descriptor (ra_server.erl await_condition state)."""

    predicate: Callable  # (event, server) -> bool
    transition_to: RaftState = RaftState.FOLLOWER
    timeout_ms: Optional[int] = None
    timeout_effects: list = field(default_factory=list)


#: backlog cap for events postponed during await_condition; beyond it the
#: oldest postponed event is dropped (the leader resends — same recovery
#: as the pre-postpone behaviour, just rarer)
MAX_CONDITION_PENDING = 1024


class RaServer:
    """One cluster member's pure Raft core."""

    def __init__(self, config: ServerConfig, log,
                 machine_config: Optional[dict] = None) -> None:
        """``machine_config`` adds keys to the config ``machine.init``
        gets (a hosting ``RaNode`` passes its ``device``, which a
        JitMachine keeps its replica state on)."""
        self.cfg = config
        self.log = log
        self._machine_config = dict(machine_config or {})
        self.id: ServerId = config.server_id
        self.machine: Machine = config.machine
        # machine-selected snapshot format (snapshot_module/0 override,
        # ra_machine.erl:435-437; behaviour ra_snapshot.erl:98-168)
        if config.machine is not None:
            mod = config.machine.snapshot_module()
            if mod is not None:
                log.snapshot_module = mod

        # persisted via the log's meta store (ra_log_meta)
        self.current_term: int = log.fetch_meta("current_term", 0)
        self.voted_for: Optional[ServerId] = log.fetch_meta("voted_for")

        self.raft_state: RaftState = RaftState.RECOVER
        self.leader_id: Optional[ServerId] = None
        self.commit_index: int = 0
        self.last_applied: int = log.fetch_meta("last_applied", 0)

        # machine versioning (ra_server.erl init + noop handling :2671-2732)
        self.machine_version: int = self.machine.version
        self.effective_machine_version: int = 0
        self.effective_machine: Machine = self.machine.which_module(0)
        self.machine_versions: list = []  # [(idx, version)] newest first

        self.cluster: dict[ServerId, Peer] = {}
        self.cluster_change_permitted: bool = False
        self.cluster_index_term: IdxTerm = IdxTerm(0, 0)
        self.previous_cluster: Optional[tuple] = None
        self.membership: Membership = config.membership

        self.votes: int = 0
        self.pre_vote_token: Any = None
        self.condition: Optional[Condition] = None
        #: events postponed while in await_condition, replayed on exit
        self.condition_pending: deque = deque()

        # consistent-query machinery (ra_server.erl:3032-3190)
        self.query_index: int = 0
        self.queries_waiting_heartbeats: list = []  # [(qidx, from, fun, ci)]
        self.pending_consistent_queries: list = []  # [(from, fun, ci)]
        # memo for _cluster_spec_at's downward scan: (idx, spec) == "the
        # newest cluster change at/below idx resolves to spec".  Entries
        # at/below a release cursor are committed and immutable, so a
        # cached answer never goes stale; it only ever narrows the scan.
        self._spec_cache: Optional[tuple] = None

        self.machine_state: Any = None
        self.aux_state: Any = self.machine.init_aux(config.uid)
        self.commit_latency: float = 0.0
        #: core-owned counters (merged into key_metrics by the shell);
        #: plain dict so the core stays free of registry dependencies.
        #: aer_batches_sent / aer_batch_entries are the leader-side
        #: replication-batching health pair: entries/batches
        #: is the realized AER batching factor
        self.stats: dict = {"term_and_voted_for_updates": 0,
                            "aer_batches_sent": 0, "aer_batch_entries": 0}
        #: bounded reservoir of recent AER batch sizes — the p50/p99
        #: substrate of RaNode.classic_stats() (CLASSIC_FIELDS)
        self._aer_batch_sizes: deque = deque(maxlen=512)
        #: batch-append fast paths when the log implements them (the
        #: durable + memory logs do; bare mocks fall back per-entry)
        self._log_append_batch = getattr(log, "append_batch", None)
        self._log_read_payloads = getattr(log, "read_range_with_payloads",
                                          None)
        self._transfer_target: Optional[ServerId] = None
        #: SnapshotMeta of an in-flight chunked install (the log owns the
        #: streamed bytes; the core only tracks which snapshot it is)
        self._accepting_snapshot: Optional[SnapshotMeta] = None
        self._persisted_last_applied: int = self.last_applied
        self._last_meta_save: float = 0.0  # throttle clock for the above

        self._init_state()

    # ------------------------------------------------------------------
    # init / recovery (ra_server.erl:249-414)
    # ------------------------------------------------------------------

    def _init_state(self) -> None:
        # persisted apply progress (lazy, ra_log_meta) marks entries as
        # known-committed; the machine state itself is rebuilt from the
        # snapshot base by re-applying them with effects suppressed
        persisted_la = self.last_applied
        # machine-state base: the newest valid of {snapshot, checkpoints}
        # (ra_snapshot:init, ra_snapshot.erl:183-222) — checkpoints cut
        # the replay span without truncating the log
        snap = self.log.recover_machine_base()
        if snap is not None:
            meta, mac_state = snap
            self.machine_state = self._placed(mac_state)
            base = meta.index
            self.effective_machine_version = meta.machine_version
            self.effective_machine = self.machine.which_module(
                meta.machine_version)
            self.machine_versions = [(meta.index, meta.machine_version)]
            self.cluster = {sid: Peer(membership=m)
                            for sid, m in meta.cluster}
            # the recovered config is as-of the snapshot point (same
            # rationale as the install path: cit must not stay 0 or the
            # config-voter fallback misfires for servers absent from
            # the snapshot's cluster)
            self.cluster_index_term = IdxTerm(meta.index, meta.term)
        else:
            self.machine_state = self.machine.init(
                {"id": self.id, "uid": self.cfg.uid,
                 "name": self.cfg.cluster_name, **self._machine_config})
            base = 0
            self.cluster = {sid: Peer() for sid in self.cfg.initial_members}
            self.machine_versions = [(0, 0)]
        if self.id not in self.cluster and not self.cluster:
            self.cluster[self.id] = Peer()
        self.membership = self._get_membership()
        self.last_applied = base
        # commit index resumes at the persisted apply watermark; recover()
        # replays (base, commit_index] (ra_server.erl:305-320, 376-414)
        self.commit_index = max(base, persisted_la)

    def _placed(self, state):
        """A snapshot's machine state on the device the machine's init
        config names (JitMachines; a host machine's state as it is)."""
        place = getattr(self.machine, "place_state", None)
        return state if place is None else place(state,
                                                 self._machine_config)

    def recover(self) -> list:
        """Replay committed-but-unapplied entries with effects suppressed
        (deduped by persisted last_applied), then scan the remainder of the
        log for cluster changes only (ra_server.erl:376-414)."""
        effects: list = []
        self._apply_to(self.commit_index, effects, suppress=True)
        # scan the un-committed tail for cluster changes (cluster_scan_fun)
        last_idx, _ = self.log.last_index_term()
        for entry in self.log.read_range(self.last_applied + 1, last_idx):
            cmd = entry.command
            if isinstance(cmd, ClusterChangeCommand):
                # record the revert baseline (an overwrite of this
                # uncommitted change after restart must restore it) and
                # order cit before _set_cluster so the cached membership
                # sees the new index (its config fallback keys on cit==0)
                self.previous_cluster = (
                    self.cluster_index_term,
                    tuple((sid, p.membership)
                          for sid, p in self.cluster.items()))
                self.cluster_index_term = IdxTerm(entry.index, entry.term)
                self._set_cluster(dict_from_cluster_spec(cmd.cluster))
        self.raft_state = RaftState.FOLLOWER
        return []

    # ------------------------------------------------------------------
    # public dispatch
    # ------------------------------------------------------------------

    def handle(self, event: Any) -> list:
        """Dispatch one event; NextEvent effects are resolved inline (they
        are the core's own re-injections, ra_server_proc's next_event), so
        callers only ever see external effects."""
        effects = self._dispatch(event)
        effects = self._convert_append_effects(effects)
        return self._resolve_next_events(effects)

    def _convert_append_effects(self, effects: list) -> list:
        """{append, Cmd} machine effects re-enter the command path on the
        leader (ra_server_proc.erl:1377-1382) — from ANY machine callback
        (apply, tick, state_enter, version bump).  A WAL-parked leader
        (await_condition -> leader) converts too: the command event is
        then postponed/replayed by the condition machinery like any other
        client command.  Non-leaders drop the effect
        (filter_follower_effects: only the leader originates the append;
        members receive it through replication)."""
        if not any(isinstance(e, AppendEffect) for e in effects):
            return effects
        is_leader = self.raft_state == RaftState.LEADER or \
            (self.raft_state == RaftState.AWAIT_CONDITION and
             self.condition is not None and
             self.condition.transition_to == RaftState.LEADER)
        out: list = []
        for e in effects:
            if isinstance(e, AppendEffect):
                if is_leader:
                    mode = e.reply_mode or ReplyMode.NOREPLY
                    follow = UserCommand(data=e.data, reply_mode=mode,
                                         correlation=e.correlation,
                                         notify_to=e.notify_to)
                    out.append(NextEvent(CommandEvent(follow)))
            else:
                out.append(e)
        return out

    def _resolve_next_events(self, effects: list) -> list:
        """NextEvents expand AFTER the current effects, mirroring
        gen_statem semantics: send effects are executed immediately
        during handle_effects while {next_event,..} actions are deferred
        to after the callback (ra_server_proc.erl:1317+).  Expanding
        inline instead would reorder the message stream — e.g. a
        commit-update AER built before a machine-appended follow-up
        would reach followers AFTER the follow-up's AER, and its stale
        prev index would look like a leader-log truncation."""
        out: list = []
        nexts: list = []
        for e in effects:
            if isinstance(e, NextEvent):
                nexts.append(e)
            else:
                out.append(e)
        for e in nexts:
            out.extend(self.handle(e.event))
        return out

    def _dispatch(self, event: Any) -> list:
        # generic non-leader fallback for client events carrying a reply
        # slot: every non-leader state (follower, candidate, pre_vote,
        # await_condition, receive_snapshot) answers not_leader immediately
        # instead of leaving the caller to time out
        if (self.raft_state != RaftState.LEADER and
                isinstance(event, (CommandEvent, ConsistentQueryEvent)) and
                event.from_ is not None and
                not (self.raft_state == RaftState.AWAIT_CONDITION and
                     self.condition is not None and
                     self.condition.transition_to == RaftState.LEADER)):
            # a parked leader (wal_down / transfer) postpones client events
            # instead of bouncing them — on resume they replay in the
            # leader state (ra_server_proc.erl:946-1010)
            return [Reply(event.from_,
                          ErrorResult("not_leader", self.leader_id))]
        if self.raft_state in (RaftState.STOP,
                               RaftState.DELETE_AND_TERMINATE):
            return []  # terminal: the shell tears this server down
        if isinstance(event, ForceMemberChangeEvent):
            # disaster-recovery escape hatch: shrink membership to self
            # only, then self-elect via pre-vote (quorum of one)
            # (ra_server.erl:830-831, :943-944, :1023-1024, :1320-1328).
            if self.raft_state == RaftState.AWAIT_CONDITION:
                # refused while parked — the reference's await_condition
                # state has no force_member_change clause (unsupported
                # call).  Exiting here would race the parked condition:
                # under a wal_down park the forced cluster-change append
                # itself fails mid-mutation (memtable advanced, cluster
                # not), and the postponed client backlog would be lost.
                if event.from_ is not None:
                    return [Reply(event.from_,
                                  ErrorResult("unsupported_call",
                                              self.leader_id))]
                return []
            if self.raft_state == RaftState.RECEIVE_SNAPSHOT:
                # a partial accept stream must not leak (the state's
                # normal exit teardown)
                self.log.abort_accept()
                self._accepting_snapshot = None
            effects = []
            if self.raft_state == RaftState.LEADER:
                # the reference re-dispatches through leader->follower
                # (ra_server.erl:830-831) so leader-only bookkeeping is
                # dropped before the shrink; do the teardown explicitly —
                # no snapshot-send token or waiting consistent query may
                # survive into the single-member configuration
                effects.extend(self._leader_teardown())
            effects.extend(self._append_cluster_change(
                {self.id: (Membership.VOTER, 0)}, None, None, []))
            if event.from_ is not None:
                effects.append(Reply(event.from_, "ok"))
            effects.extend(self._call_for_election_pre_vote())
            return effects
        if isinstance(event, AuxCommandEvent):
            return self.handle_aux("cmd", event.cmd, event.from_)
        handler = {
            RaftState.LEADER: self._handle_leader,
            RaftState.FOLLOWER: self._handle_follower,
            RaftState.CANDIDATE: self._handle_candidate,
            RaftState.PRE_VOTE: self._handle_pre_vote,
            RaftState.AWAIT_CONDITION: self._handle_await_condition,
            RaftState.RECEIVE_SNAPSHOT: self._handle_receive_snapshot,
        }[self.raft_state]
        return handler(event)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _update_term(self, term: int) -> None:
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self.stats["term_and_voted_for_updates"] += 1
            self.log.store_meta(current_term=term, voted_for=None)

    def _update_term_and_voted_for(self, term: int,
                                   voted_for: Optional[ServerId]) -> None:
        if term != self.current_term or voted_for != self.voted_for:
            self.current_term = term
            self.voted_for = voted_for
            self.stats["term_and_voted_for_updates"] += 1
            self.log.store_meta(current_term=term, voted_for=voted_for)

    def _applied_idx_term(self) -> IdxTerm:
        """(last_applied, its term) — the validated progress marker used
        by rewind/refusal replies.  fetch_term covers the snapshot index
        itself; anything below it is 0 (never sent in practice: applied
        never trails the snapshot)."""
        la = self.last_applied
        return IdxTerm(la, self.log.fetch_term(la) or 0)

    def last_idx_term(self) -> IdxTerm:
        """Effective last idx/term: log tail or snapshot (last_idx_term)."""
        lit = self.log.last_index_term()
        snap = self.log.snapshot_index_term()
        if snap.index > lit.index:
            return snap
        return lit

    def _peer_ids(self) -> list:
        return [pid for pid in self.cluster if pid != self.id]

    def _voter_count(self) -> int:
        return sum(1 for p in self.cluster.values()
                   if p.membership == Membership.VOTER)

    def required_quorum(self) -> int:
        return self._voter_count() // 2 + 1

    def _get_membership(self) -> Membership:
        peer = self.cluster.get(self.id)
        if peer is not None:
            return peer.membership
        if self.cluster_index_term.index == 0:
            # not in our own view and NO cluster change ever seen: a
            # freshly-started member whose '$ra_join' has not reached
            # it.  Voter-ness comes from the server CONFIG
            # (ra_server.erl:349-350 falls back to the config
            # membership) — without this a joined voter with an empty
            # log ignores vote requests and can veto elections forever
            # (found by the membership fuzz).
            return self.cfg.membership
        # absent from a view SHAPED BY a cluster change: we were
        # removed.  The config fallback must not apply — a removed
        # server that considered itself a voter would self-elect
        # against a quorum computed over a config that excludes it
        # (also found by the membership fuzz: a one-peer view makes
        # required_quorum 1, so the stale self-vote alone would seat a
        # bogus leader)
        return Membership.UNKNOWN

    def _set_cluster(self, new_cluster: dict[ServerId, Peer]) -> None:
        # preserve replication state of peers we already track
        for sid, peer in new_cluster.items():
            if sid in self.cluster:
                old = self.cluster[sid]
                peer.next_index = old.next_index
                peer.match_index = old.match_index
                peer.commit_index_sent = old.commit_index_sent
                peer.query_index = old.query_index
                peer.status = old.status
        self.cluster = new_cluster
        self.membership = self._get_membership()

    def is_voter(self) -> bool:
        return self.membership == Membership.VOTER

    def _aer_reply(self, term: int, success: bool) -> AppendEntriesReply:
        """Reply uses last *written* for match info but unwritten last index
        for next_index (ra_server.erl:2927-2939)."""
        lw = self.log.last_written()
        snap = self.log.snapshot_index_term()
        if snap.index > lw.index:
            lw = snap
        last_idx = self.last_idx_term().index
        return AppendEntriesReply(term=term, success=success,
                                  next_index=last_idx + 1,
                                  last_index=lw.index, last_term=lw.term,
                                  from_=self.id)

    def _heartbeat_reply(self) -> HeartbeatReply:
        return HeartbeatReply(query_index=self.query_index,
                              term=self.current_term, from_=self.id)

    # ------------------------------------------------------------------
    # elections (ra_server.erl:2211-2330)
    # ------------------------------------------------------------------

    def _call_for_election_pre_vote(self) -> list:
        # token must survive serialization (compared by value, not
        # identity — it crosses the wire on TCP transports)
        import uuid as _uuid
        self.pre_vote_token = _uuid.uuid4().hex
        last = self.last_idx_term()
        reqs = tuple(
            (pid, PreVoteRpc(term=self.current_term, token=self.pre_vote_token,
                             candidate_id=self.id, version=RA_PROTO_VERSION,
                             machine_version=self.machine_version,
                             last_log_index=last.index,
                             last_log_term=last.term))
            for pid in self._peer_ids())
        self._update_term_and_voted_for(self.current_term, self.id)
        self.leader_id = None
        self.votes = 0
        self.raft_state = RaftState.PRE_VOTE
        self_vote = PreVoteResult(term=self.current_term,
                                  token=self.pre_vote_token,
                                  vote_granted=True, from_=self.id)
        return [NextEvent(self_vote), SendVoteRequests(reqs),
                StartElectionTimeout("long")]

    def _call_for_election_candidate(self) -> list:
        new_term = self.current_term + 1
        last = self.last_idx_term()
        reqs = tuple(
            (pid, RequestVoteRpc(term=new_term, candidate_id=self.id,
                                 last_log_index=last.index,
                                 last_log_term=last.term))
            for pid in self._peer_ids())
        self._update_term_and_voted_for(new_term, self.id)
        self.leader_id = None
        self.votes = 0
        self.raft_state = RaftState.CANDIDATE
        self_vote = RequestVoteResult(term=new_term, vote_granted=True,
                                      from_=self.id)
        return [NextEvent(self_vote), SendVoteRequests(reqs),
                StartElectionTimeout("long")]

    def _process_pre_vote(self, rpc: PreVoteRpc) -> list:
        """Grant/deny a pre-vote without changing durable vote state
        beyond term adoption (ra_server.erl:2260-2319)."""
        if rpc.term < self.current_term:
            return [SendRpc(rpc.candidate_id,
                            PreVoteResult(term=self.current_term,
                                          token=rpc.token, vote_granted=False,
                                          from_=self.id))]
        self._update_term(rpc.term)
        last = self.last_idx_term()
        up_to_date = _log_up_to_date(rpc.last_log_index, rpc.last_log_term,
                                     last)
        if up_to_date and rpc.version > RA_PROTO_VERSION:
            granted = False
        elif up_to_date and (
                rpc.machine_version == self.effective_machine_version or
                (rpc.machine_version >= self.effective_machine_version and
                 rpc.machine_version <= self.machine_version)):
            self.voted_for = rpc.candidate_id
            granted = True
        else:
            granted = False
        effects: list = []
        if granted or self.raft_state != RaftState.FOLLOWER:
            effects.append(SendRpc(rpc.candidate_id,
                                   PreVoteResult(term=rpc.term,
                                                 token=rpc.token,
                                                 vote_granted=granted,
                                                 from_=self.id)))
        if not granted and self.raft_state == RaftState.FOLLOWER:
            effects.append(StartElectionTimeout("medium"))
        return effects

    def _process_request_vote(self, rpc: RequestVoteRpc) -> list:
        """Follower-side vote granting (ra_server.erl:1211-1251)."""
        if rpc.term < self.current_term:
            return [SendRpc(rpc.candidate_id,
                            RequestVoteResult(term=self.current_term,
                                              vote_granted=False,
                                              from_=self.id))]
        if (rpc.term == self.current_term and self.voted_for is not None
                and self.voted_for != rpc.candidate_id):
            return [SendRpc(rpc.candidate_id,
                            RequestVoteResult(term=rpc.term,
                                              vote_granted=False,
                                              from_=self.id))]
        self._update_term(rpc.term)
        last = self.last_idx_term()
        if _log_up_to_date(rpc.last_log_index, rpc.last_log_term, last):
            self._update_term_and_voted_for(rpc.term, rpc.candidate_id)
            return [SendRpc(rpc.candidate_id,
                            RequestVoteResult(term=rpc.term,
                                              vote_granted=True,
                                              from_=self.id)),
                    StartElectionTimeout("long")]
        return [SendRpc(rpc.candidate_id,
                        RequestVoteResult(term=rpc.term, vote_granted=False,
                                          from_=self.id))]

    def _leader_teardown(self) -> list:
        """Abandon leader-only bookkeeping on an involuntary step-down.

        Waiting/pending consistent queries are answered not_leader — the
        reference parks them and redirects once a new leader is known
        (process_new_leader_queries, ra_server.erl:1500-1510); with no
        successor known at teardown time not_leader is the honest reply
        and clients re-resolve.  In-flight snapshot-send tokens are
        invalidated so a late SnapshotSenderDone from a dead leadership
        cannot flip a peer back to NORMAL under a different regime."""
        effects: list = []
        for _qidx, from_, _fun, _ci in self.queries_waiting_heartbeats:
            if from_ is not None:
                effects.append(Reply(from_,
                                     ErrorResult("not_leader", None)))
        for from_, _fun, _ci in self.pending_consistent_queries:
            if from_ is not None:
                effects.append(Reply(from_,
                                     ErrorResult("not_leader", None)))
        self.queries_waiting_heartbeats = []
        self.pending_consistent_queries = []
        for peer in self.cluster.values():
            peer.snapshot_sender = None
            if peer.status == PeerStatus.SENDING_SNAPSHOT:
                peer.status = PeerStatus.NORMAL
        self.votes = 0
        return effects

    def _become_follower(self, term: int,
                         next_event: Any = None) -> list:
        # an actual LEADER stepping down (higher-term RPC/reply) drops
        # its leader-only bookkeeping here — the one choke point every
        # involuntary step-down goes through
        pre = (self._leader_teardown()
               if self.raft_state == RaftState.LEADER else [])
        self._update_term(term)
        self.leader_id = None
        self.votes = 0
        self.raft_state = RaftState.FOLLOWER
        effects: list = pre + [StartElectionTimeout("medium")]
        if next_event is not None:
            effects.insert(0, NextEvent(next_event))
        return effects

    def _become_leader(self) -> list:
        """Candidate won: initialise peers, establish leadership, append the
        noop for this term (ra_server.erl:845-859)."""
        self.leader_id = self.id
        self.raft_state = RaftState.LEADER
        self.votes = 0
        last_idx = self.last_idx_term().index
        for pid, peer in self.cluster.items():
            peer.next_index = last_idx + 1
            peer.match_index = 0
            peer.commit_index_sent = 0
            peer.query_index = 0
            if peer.status != PeerStatus.SENDING_SNAPSHOT:
                peer.status = PeerStatus.NORMAL
        self.cluster_change_permitted = False
        effects = self._make_all_rpcs()
        noop = NoopCommand(machine_version=self.machine_version)
        effects.append(NextEvent(CommandEvent(noop)))
        effects.append(RecordLeader(self.cfg.cluster_name, self.id,
                                    tuple(self.cluster)))
        effects.append(CancelElectionTimeout())
        # machine state_enter(leader) — re-establishes machine monitors
        # after failover (ra_server_proc state_enter effects; ra_machine
        # state_enter/2)
        effects.extend(self.effective_machine.state_enter(
            "leader", self.machine_state) or [])
        return effects

    # ------------------------------------------------------------------
    # follower (ra_server.erl:1032-1330)
    # ------------------------------------------------------------------

    def _handle_follower(self, event: Any) -> list:
        if isinstance(event, AppendEntriesRpc):
            return self._follower_aer(event)
        if isinstance(event, HeartbeatRpc):
            if event.term >= self.current_term:
                self._update_term(event.term)
                self.leader_id = event.leader_id
                self.query_index = max(self.query_index, event.query_index)
                return [SendRpc(event.leader_id, self._heartbeat_reply()),
                        StartElectionTimeout("medium")]
            return [SendRpc(event.leader_id, self._heartbeat_reply())]
        if isinstance(event, WrittenEvent):
            self.log.handle_written(event)
            effects: list = []
            # replicate-then-confirm: reply to the leader once our WAL
            # confirms (ra_server.erl:1183-1192).  NB: the commit index
            # is NOT evaluated here — commit_index is optimistically set
            # to leader_commit BEFORE the AER consistency check (both
            # here and in the reference, :1047-1048), so it may cover a
            # stale uncommitted suffix of a previous term that a failed
            # check left in place.  Applying is only safe from the AER
            # entry_ok path, where the prefix up to the leader's tail
            # has been validated (or reset) — exactly the reference's
            # shape, whose follower written-event clause only replies.
            if self.leader_id is not None:
                effects.append(SendRpc(self.leader_id,
                                       self._aer_reply(self.current_term,
                                                       True)))
            return effects
        if isinstance(event, PreVoteRpc):
            # DESIGN DIVERGENCE from the reference: every server grants
            # (pre-)votes based on term/votedFor/log alone — canonical
            # Raft.  The reference gates granting on the granter's OWN
            # membership (ra_server.erl:1197-1210), but a granter's
            # self-view can be arbitrarily stale in BOTH directions
            # (promoted-but-unaware, joined-but-uncaught-up), and the
            # fuzzers showed each one deadlocking elections that need
            # that vote.  Safety lives on the COUNTING side instead
            # (_count_grant: a candidate tallies only voters of its own
            # configuration), which the reference lacks.  Membership
            # still gates STANDING for election (the timeout below).
            return self._process_pre_vote(event)
        if isinstance(event, RequestVoteRpc):
            return self._process_request_vote(event)
        if isinstance(event, InstallSnapshotRpc):
            return self._follower_install_snapshot(event)
        if isinstance(event, (AppendEntriesReply, HeartbeatReply)):
            self._update_term(event.term)
            return []
        if isinstance(event, (RequestVoteResult, PreVoteResult)):
            return []
        if isinstance(event, ElectionTimeout):
            if not (self.is_voter() or self._removed_but_uncommitted()):
                return []
            return self._call_for_election_pre_vote()
        if isinstance(event, ForceElectionEvent):
            return self._call_for_election_candidate()
        if isinstance(event, TransferLeadershipEvent):
            # try_become_leader arrives at the transfer target as this event
            return self._call_for_election_pre_vote()
        if isinstance(event, CommandsEvent):
            # relay pipelined batches to the leader (the reference's
            # follower cast-forwarding, ra_server_proc.erl:822-849)
            if self.leader_id is not None and self.leader_id != self.id:
                return [SendRpc(self.leader_id, event)]
            return []
        if isinstance(event, CommandEvent) and event.from_ is None:
            if self.leader_id is not None and self.leader_id != self.id:
                return [SendRpc(self.leader_id, event)]
            return []
        if isinstance(event, (CommandEvent, ConsistentQueryEvent)):
            return []  # from_-carrying events answered by _dispatch fallback
        if isinstance(event, NodeEvent):
            # failure-detector verdict on the leader's node: arm an election
            # (the aten-driven path, ra_server_proc.erl:790-810)
            if (event.status == "down" and self.leader_id is not None
                    and event.node == self.leader_id.node
                    and self.is_voter()):
                return [StartElectionTimeout("short")]
            return []
        if isinstance(event, DownEvent):
            if (self.leader_id is not None and event.target == self.leader_id
                    and self.is_voter()):
                return [StartElectionTimeout("really_short")]
            return []
        if isinstance(event, TickEvent):
            return self._tick()
        return []

    def _follower_aer(self, rpc: AppendEntriesRpc) -> list:
        if rpc.term < self.current_term:
            return [SendRpc(rpc.leader_id,
                            self._aer_reply(self.current_term, False))]
        # valid leader for this term (ra_server.erl:1032-1156)
        effects: list = [StartElectionTimeout("medium")]
        self._update_term(rpc.term)
        self.leader_id = rpc.leader_id
        self.commit_index = max(self.commit_index, rpc.leader_commit)
        check = self._has_log_entry_or_snapshot(rpc.prev_log_index,
                                                rpc.prev_log_term)
        if check == "ok":
            entries = list(rpc.entries)
            payloads = rpc.payloads
            dropped = self._count_existing(entries)
            if dropped:
                entries = entries[dropped:]
                if payloads is not None:
                    payloads = payloads[dropped:]
            if not entries:
                last_idx = self.log.last_index_term().index
                if not rpc.entries and last_idx > rpc.prev_log_index:
                    # leader's log is shorter: reset ours to match
                    # (ra_server.erl:1056-1066) — but NEVER below our
                    # APPLIED index: applied entries are immutable, and
                    # a stale/pipelined empty AER can carry a prev point
                    # under them (found by the snapshot fuzz: the
                    # unclamped reset left applied > tail, wedging the
                    # member in an install-refusal livelock).  NB the
                    # clamp bound is last_applied, NOT commit_index —
                    # commit_index is adopted optimistically before the
                    # consistency check, so clamping there could retain
                    # (and then apply) never-validated stale entries in
                    # (prev, commit]; unapplied entries are always safe
                    # to truncate and re-receive.
                    new_tail = max(rpc.prev_log_index, self.last_applied)
                    self.log.set_last_index(new_tail)
                    # the reset may have truncated the entry whose
                    # cluster change this server adopted — revert NOW,
                    # not at the next append: a truncated server can
                    # win an election first and overwrite the change's
                    # index with its own noop, freezing a phantom
                    # configuration (soak seed 161122: the final leader
                    # held a config whose change entry no log carried)
                    self._revert_config_below(new_tail)
                effects.extend(self._evaluate_commit_index_follower())
                effects.append(SendRpc(rpc.leader_id,
                                       self._aer_reply(rpc.term, True)))
                return effects
            self._adopt_cluster_changes(entries)
            # the frame's pre-encoded durable images (when shipped)
            # ride into the log so the batch write skips re-encoding
            # (one WAL fan-in submit either way)
            if payloads is not None:
                self.log.write(entries, payloads)
            else:
                self.log.write(entries)
            effects.extend(self._evaluate_commit_index_follower())
            # success reply is sent when the WrittenEvent arrives
            return effects
        if check == "missing":
            # gap: ask leader to resend from our next index and hold in
            # await_condition for the entries to arrive out of order
            # (ra_server.erl:1118-1133)
            reply_eff = SendRpc(rpc.leader_id,
                                self._aer_reply(rpc.term, False))
            self.condition = Condition(
                predicate=_follower_catchup_predicate,
                transition_to=RaftState.FOLLOWER,
                timeout_ms=self.cfg.await_condition_timeout_ms,
                timeout_effects=[reply_eff])
            self.raft_state = RaftState.AWAIT_CONDITION
            effects.append(reply_eff)
            return effects
        # term mismatch: rewind to last_applied (ra_server.erl:1134-1156)
        la, la_term = self._applied_idx_term()
        reply = AppendEntriesReply(term=rpc.term, success=False,
                                   next_index=la + 1, last_index=la,
                                   last_term=la_term, from_=self.id)
        reply_eff = SendRpc(rpc.leader_id, reply)
        self.condition = Condition(
            predicate=_follower_catchup_predicate,
            transition_to=RaftState.FOLLOWER,
            timeout_ms=self.cfg.await_condition_timeout_ms,
            timeout_effects=[reply_eff])
        self.raft_state = RaftState.AWAIT_CONDITION
        effects.append(reply_eff)
        return effects

    def _has_log_entry_or_snapshot(self, idx: int, term: int) -> str:
        if idx == 0:
            return "ok"
        t = self.log.fetch_term(idx)
        if t is None:
            snap = self.log.snapshot_index_term()
            if snap.index == idx and snap.term == term:
                return "ok"
            return "missing"
        return "ok" if t == term else "term_mismatch"

    def _count_existing(self, entries: list) -> int:
        """How many leading entries are already present with the same
        idx+term (the drop_existing prefix length — returned as a count
        so the AER path can slice the shipped payloads in step)."""
        i = 0
        while i < len(entries) and self.log.exists(entries[i].index,
                                                   entries[i].term):
            i += 1
        return i

    def _adopt_cluster_changes(self, entries: list) -> None:
        """Followers adopt cluster changes when the entry is ADDED to
        the log, not when it applies (pre_append_log_follower,
        ra_server.erl:2865-2889): membership must be current for
        elections even while the apply frontier lags — e.g. the sole
        surviving member after the leader's own removal commits must
        know the new cluster to elect itself.

        ``entries`` is the post-drop_existing batch the caller is about
        to write, so every entry genuinely lands (new or conflicting).
        A batch starting at or below the recorded change index
        overwrites/TRUNCATES that change, so the view reverts to the
        prior configuration first — regardless of what the batch itself
        carries — and only then adopts any change in the batch (with
        the reverted config as its ``previous``, never the deposed
        leader's phantom one).  cluster_index_term is updated BEFORE
        _set_cluster so the cached membership (whose config fallback
        keys on cit==0) is computed against the new index."""
        if not entries:
            return
        self._revert_config_below(entries[0].index - 1)
        for e in entries:
            if isinstance(e.command, ClusterChangeCommand):
                self.previous_cluster = (
                    self.cluster_index_term,
                    tuple((sid, p.membership)
                          for sid, p in self.cluster.items()))
                self.cluster_index_term = IdxTerm(e.index, e.term)
                self._set_cluster(
                    dict_from_cluster_spec(e.command.cluster))

    def _revert_config_below(self, surviving_tail: int) -> None:
        """The log above ``surviving_tail`` is being discarded (an
        overwriting append batch, or the empty-AER shorter-log reset):
        if the adopted cluster change sat above it, the effective
        configuration must revert to what the surviving prefix says.
        previous_cluster covers the common one-change-rewind; when BOTH
        recorded changes are truncated, rescan the surviving prefix
        (newest change wins, snapshot meta as the base — the same
        resolution order as _cluster_spec_at)."""
        if self.cluster_index_term.index <= surviving_tail:
            return
        if self.previous_cluster is not None and \
                self.previous_cluster[0].index <= surviving_tail:
            prev_it, prev_spec = self.previous_cluster
            self.previous_cluster = None
            self.cluster_index_term = prev_it
            self._set_cluster(dict_from_cluster_spec(prev_spec))
            return
        self.previous_cluster = None
        for i in range(surviving_tail, self.log.first_index() - 1, -1):
            e = self.log.fetch(i)
            if e is not None and isinstance(e.command,
                                            ClusterChangeCommand):
                self.cluster_index_term = IdxTerm(e.index, e.term)
                self._set_cluster(
                    dict_from_cluster_spec(tuple(e.command.cluster)))
                return
        meta = self.log.snapshot_meta()
        if meta is not None:
            self.cluster_index_term = IdxTerm(meta.index, meta.term)
            self._set_cluster(dict_from_cluster_spec(tuple(meta.cluster)))
            return
        # no surviving change and no snapshot: back to the bootstrap
        # configuration (cit (0,0) keys the fresh-member config fallback,
        # same as init) — leaving the truncated view in force would keep
        # a phantom membership no log carries
        self.cluster_index_term = IdxTerm(0, 0)
        self._set_cluster({sid: Peer() for sid in self.cfg.initial_members})

    def _evaluate_commit_index_follower(self) -> list:
        """Apply up to min(last_index, commit_index) — may apply entries not
        yet fsynced locally; safe per the argument in
        ra_server.erl:1780-1813."""
        if self.leader_id is None:
            return []
        last_idx = self.log.last_index_term().index
        apply_to = min(last_idx, self.commit_index)
        effects: list = []
        self._apply_to(apply_to, effects)
        return _filter_follower_effects(effects)

    def _follower_install_snapshot(self, rpc: InstallSnapshotRpc) -> list:
        if rpc.term < self.current_term:
            return [SendRpc(rpc.leader_id,
                            InstallSnapshotResult(
                                term=self.current_term,
                                last_index=rpc.meta.index,
                                last_term=rpc.meta.term, from_=self.id,
                                token=rpc.token))]
        # restorative install: a member whose durable tail fell behind
        # its own applied index (e.g. a crash reverted the log while
        # meta.last_applied survived) must accept a snapshot AT its
        # applied index — refusing it as "stale" wedges the member
        # forever once the leader has compacted those entries
        restores_log = (rpc.meta.index >= self.last_applied and
                        rpc.meta.index >
                        self.log.last_index_term().index)
        if (rpc.chunk_number == 1
                and (rpc.meta.index > self.last_applied or restores_log)
                and self.machine_version >= rpc.meta.machine_version):
            self._update_term(rpc.term)
            self.leader_id = rpc.leader_id
            self._accepting_snapshot = rpc.meta
            self.log.begin_accept(rpc.meta)
            self.raft_state = RaftState.RECEIVE_SNAPSHOT
            return [NextEvent(rpc), StartElectionTimeout("medium")]
        # stale snapshot: confirm our progress so the leader can resume
        # replication.  The marker is the APPLIED frontier, not the raw
        # log tail: the tail may be a deposed leader's unvalidated
        # suffix, and advertising it sends the leader's repair below its
        # own snapshot — re-triggering the very install we just refused,
        # forever (found by the snapshot fuzz).  The applied point is
        # always validated state the leader can safely resume above.
        la, la_term = self._applied_idx_term()
        return [SendRpc(rpc.leader_id,
                        InstallSnapshotResult(term=self.current_term,
                                              last_index=la,
                                              last_term=la_term,
                                              from_=self.id,
                                              token=rpc.token))]

    # ------------------------------------------------------------------
    # receive_snapshot state (ra_server.erl:1333-1413)
    # ------------------------------------------------------------------

    def _handle_receive_snapshot(self, event: Any) -> list:
        if isinstance(event, InstallSnapshotRpc):
            if event.term < self.current_term:
                return []
            if event.chunk_number == 1 and \
                    event.meta != self._accepting_snapshot:
                # the leader restarted the transfer (e.g. it crashed and
                # a new leader owns a newer snapshot): begin again — the
                # partial stream is discarded (ra_snapshot.erl:465-508)
                self._accepting_snapshot = event.meta
                self.log.begin_accept(event.meta)
            meta = self._accepting_snapshot
            ok = self.log.accept_chunk(event.data, event.chunk_number,
                                       event.chunk_crc)
            if not ok:
                # corrupt chunk (or no stream): abort the install; our
                # unchanged progress report makes the leader restart
                self.log.abort_accept()
                self._accepting_snapshot = None
                self.raft_state = RaftState.FOLLOWER
                last = self.last_idx_term()
                return [SendRpc(event.leader_id,
                                InstallSnapshotResult(
                                    term=self.current_term,
                                    last_index=last.index,
                                    last_term=last.term, from_=self.id,
                                    token=event.token)),
                        StartElectionTimeout("medium")]
            if event.chunk_flag == "last":
                if not self.log.complete_accept():
                    self._accepting_snapshot = None
                    self.raft_state = RaftState.FOLLOWER
                    return [StartElectionTimeout("medium")]
                recovered = self.log.recover_snapshot_state()
                assert recovered is not None
                old_state = self.machine_state
                self.machine_state = self._placed(recovered[1])
                self.last_applied = meta.index
                self.commit_index = max(self.commit_index, meta.index)
                self.effective_machine_version = meta.machine_version
                self.effective_machine = self.machine.which_module(
                    meta.machine_version)
                # the installed config is as-of the snapshot point: the
                # change index MUST move with it, or it stays 0 and the
                # config-voter fallback re-arms — a server absent from
                # the installed cluster would then self-elect against a
                # quorum that excludes it (found by the combined fuzz)
                self.cluster_index_term = IdxTerm(meta.index, meta.term)
                self.previous_cluster = None
                self._set_cluster({sid: Peer(membership=m)
                                   for sid, m in meta.cluster})
                # the log RETAINS any consistent suffix above the
                # snapshot (install-at-applied-index restoration):
                # config changes in it are NEWER than the meta and must
                # stay in force — pinning only the meta silently
                # regressed this server's view to a config two changes
                # old, and it later elected itself under the stale
                # (larger) membership against a quorum the committed
                # chain had dissolved (soak seed 181279)
                retained = [
                    e for e in self.log.read_range(
                        meta.index + 1, self.log.last_index_term().index)
                    if isinstance(e.command, ClusterChangeCommand)]
                self._adopt_cluster_changes(retained)
                self._accepting_snapshot = None
                self.raft_state = RaftState.FOLLOWER
                effs = list(self.machine.snapshot_installed(
                    meta, self.machine_state, None, old_state))
                effs.append(SendRpc(event.leader_id,
                                    InstallSnapshotResult(
                                        term=self.current_term,
                                        last_index=meta.index,
                                        last_term=meta.term, from_=self.id,
                                        token=event.token)))
                effs.append(StartElectionTimeout("medium"))
                return effs
            return [SendRpc(event.leader_id,
                            InstallSnapshotResult(term=self.current_term,
                                                  last_index=meta.index,
                                                  last_term=meta.term,
                                                  from_=self.id,
                                                  token=event.token))]
        if isinstance(event, AppendEntriesRpc) and \
                event.term >= self.current_term:
            # a leader in a newer term interrupts the transfer
            self.log.abort_accept()
            self._accepting_snapshot = None
            self.raft_state = RaftState.FOLLOWER
            return [NextEvent(event)]
        if isinstance(event, ElectionTimeout):
            self.log.abort_accept()
            self._accepting_snapshot = None
            self.raft_state = RaftState.FOLLOWER
            return [StartElectionTimeout("medium")]
        if isinstance(event, WrittenEvent):
            self.log.handle_written(event)
            return []
        return []

    # ------------------------------------------------------------------
    # candidate (ra_server.erl:745-950)
    # ------------------------------------------------------------------

    def _count_grant(self, from_: Any) -> bool:
        """A grant counts toward quorum only when the granter is a VOTER
        of the candidate's OWN configuration (dissertation §4.2.2 vote
        tallying).  A fresh member's config-fallback voter-ness lets it
        grant before its cluster view catches up; an old-config
        candidate must not count such a grant against its (smaller)
        voter quorum — two leaders in one term otherwise (found by the
        membership fuzz).  The SELF-vote follows the same rule: a
        candidate absent from its own configuration (removed by an
        uncommitted change — see _removed_but_uncommitted) does not
        count itself; it needs a full quorum of the new config's
        voters.  Before any cluster change is known (bootstrap), the
        self-vote counts."""
        if from_ == self.id:
            peer = self.cluster.get(self.id)
            if peer is not None:
                return peer.membership == Membership.VOTER
            return self.cluster_index_term.index == 0
        peer = self.cluster.get(from_)
        return peer is not None and peer.membership == Membership.VOTER

    def _removed_but_uncommitted(self) -> bool:
        """Dissertation §4.2.2: a server absent from its own latest
        configuration keeps standing for election until the removing
        change COMMITS — it may still be needed, e.g. when it holds the
        longest log (containing that very change) and no new-config
        member can win without first obtaining it."""
        return (self.id not in self.cluster and
                self.cluster_index_term.index > self.commit_index)

    def _handle_candidate(self, event: Any) -> list:
        if isinstance(event, RequestVoteResult):
            if event.term > self.current_term:
                self._update_term_and_voted_for(event.term, None)
                return self._become_follower(event.term)
            if not event.vote_granted or event.term != self.current_term \
                    or not self._count_grant(event.from_):
                return []
            self.votes += 1
            if self.votes == self.required_quorum():
                return self._become_leader()
            return []
        if isinstance(event, AppendEntriesRpc):
            if event.term >= self.current_term:
                self._update_term_and_voted_for(event.term, None)
                return self._become_follower(event.term, next_event=event)
            return [SendRpc(event.leader_id,
                            self._aer_reply(self.current_term, False))]
        if isinstance(event, HeartbeatRpc):
            if event.term >= self.current_term:
                self._update_term_and_voted_for(event.term, None)
                return self._become_follower(event.term, next_event=event)
            return [SendRpc(event.leader_id, self._heartbeat_reply())]
        if isinstance(event, (AppendEntriesReply, HeartbeatReply)):
            if event.term > self.current_term:
                self._update_term_and_voted_for(event.term, None)
                return self._become_follower(event.term)
            return []
        if isinstance(event, RequestVoteRpc):
            if event.term > self.current_term:
                self._update_term_and_voted_for(event.term, None)
                eff = self._become_follower(event.term)
                return [NextEvent(event)] + eff
            return [SendRpc(event.candidate_id,
                            RequestVoteResult(term=self.current_term,
                                              vote_granted=False,
                                              from_=self.id))]
        if isinstance(event, PreVoteRpc):
            if event.term > self.current_term:
                self._update_term_and_voted_for(event.term, None)
                eff = self._become_follower(event.term)
                return [NextEvent(event)] + eff
            # candidate cannot simply reject (rabbitmq/ra#439)
            return self._process_pre_vote(event)
        if isinstance(event, InstallSnapshotRpc):
            if event.term >= self.current_term:
                return self._become_follower(event.term, next_event=event)
            # stale install chunk: refuse with OUR term (the follower
            # state's stale branch, :890-896) — found by the snapshot
            # soak (seeds 401146/401363/402692): a candidate that
            # dropped these silently left the deposed-but-unaware
            # leader retrying the install forever — with the peer in
            # SENDING_SNAPSHOT it gets no AER traffic either, so
            # nothing ever carried the higher term back
            last = self.last_idx_term()
            return [SendRpc(event.leader_id,
                            InstallSnapshotResult(
                                term=self.current_term,
                                last_index=last.index,
                                last_term=last.term, from_=self.id,
                                token=event.token))]
        if isinstance(event, PreVoteResult):
            return []
        if isinstance(event, ElectionTimeout):
            return self._call_for_election_candidate()
        if isinstance(event, WrittenEvent):
            self.log.handle_written(event)
            return []
        if isinstance(event, TickEvent):
            return self._tick()
        return []

    # ------------------------------------------------------------------
    # pre_vote (ra_server.erl:952-1030)
    # ------------------------------------------------------------------

    def _handle_pre_vote(self, event: Any) -> list:
        if isinstance(event, PreVoteResult):
            if event.term > self.current_term:
                return self._become_follower(event.term)
            if (event.vote_granted and event.token == self.pre_vote_token
                    and event.term == self.current_term
                    and self._count_grant(event.from_)):
                self.votes += 1
                if self.votes == self.required_quorum():
                    return self._call_for_election_candidate()
            return []
        if isinstance(event, (AppendEntriesRpc, HeartbeatRpc)):
            if event.term >= self.current_term:
                self._update_term(event.term)
                self.votes = 0
                self.raft_state = RaftState.FOLLOWER
                return [NextEvent(event)]
            if isinstance(event, HeartbeatRpc):
                return [SendRpc(event.leader_id, self._heartbeat_reply())]
            # stale AER: answer success=false with our term, exactly as
            # the follower state would — pre-vote never bumped the term,
            # so this is the deposed-leader path, not an election race
            return [SendRpc(event.leader_id,
                            self._aer_reply(self.current_term, False))]
        if isinstance(event, (AppendEntriesReply, HeartbeatReply)):
            if event.term > self.current_term:
                return self._become_follower(event.term)
            return []
        if isinstance(event, RequestVoteRpc):
            if event.term > self.current_term:
                eff = self._become_follower(event.term)
                return [NextEvent(event)] + eff
            return []
        if isinstance(event, InstallSnapshotRpc):
            if event.term >= self.current_term:
                self.votes = 0
                self.raft_state = RaftState.FOLLOWER
                return [NextEvent(event)]
            # stale install chunk: refuse with our term, exactly as the
            # follower state would (:890-896)
            last = self.last_idx_term()
            return [SendRpc(event.leader_id,
                            InstallSnapshotResult(
                                term=self.current_term,
                                last_index=last.index,
                                last_term=last.term, from_=self.id,
                                token=event.token))]
        if isinstance(event, PreVoteRpc):
            return self._process_pre_vote(event)
        if isinstance(event, RequestVoteResult):
            return []
        if isinstance(event, ElectionTimeout):
            return self._call_for_election_pre_vote()
        if isinstance(event, WrittenEvent):
            self.log.handle_written(event)
            return []
        if isinstance(event, TickEvent):
            return self._tick()
        return []

    # ------------------------------------------------------------------
    # leader (ra_server.erl:418-760)
    # ------------------------------------------------------------------

    def _handle_leader(self, event: Any) -> list:
        if isinstance(event, AppendEntriesReply):
            return self._leader_aer_reply(event)
        if isinstance(event, CommandEvent):
            return self._leader_command(event.command, event.from_)
        if isinstance(event, CommandsEvent):
            effects = self._leader_append_batch(event.commands,
                                                event.images)
            effects.extend(self._make_pipelined_rpcs())
            return effects
        if isinstance(event, WrittenEvent):
            self.log.handle_written(event)
            effects = self._evaluate_quorum()
            effects.extend(self._process_pending_consistent_queries())
            effects.extend(self._make_pipelined_rpcs())
            return effects
        if isinstance(event, InstallSnapshotResult):
            if event.term > self.current_term:
                self._update_term(event.term)
                self.leader_id = None
                return self._become_follower(event.term)
            peer = self.cluster.get(event.from_)
            if peer is None:
                return []
            if peer.snapshot_sender is not None and \
                    event.token != peer.snapshot_sender:
                # straggler result from an abandoned (timed-out)
                # transfer: must not regress the live transfer's state
                return []
            peer.status = PeerStatus.NORMAL
            peer.snapshot_sender = None
            # a REFUSED install reports the follower's own (possibly
            # stale) tail — verify it like an AER success confirm
            # before it may touch match (the combined fuzz found the
            # unchecked form looping forever: match poisoned beyond our
            # log -> prev unverifiable -> another snapshot send -> the
            # follower refuses again with the same stale tail)
            my_last = self.log.last_index_term().index
            verifiable = event.last_index >= self.log.first_index()
            if event.last_index > 0 and verifiable and \
                    self.log.fetch_term(event.last_index) != \
                    event.last_term:
                if event.last_index > my_last:
                    # stale surplus: only the empty-AER reset truncates
                    peer.next_index = my_last + 1
                    eff = self._make_rpc_for_peer(event.from_, peer, 1)
                    return [eff] if eff is not None else []
                peer.next_index = peer.match_index + 1
                return self._make_pipelined_rpcs()
            peer.match_index = max(peer.match_index, event.last_index)
            peer.commit_index_sent = event.last_index
            peer.next_index = event.last_index + 1
            return self._make_pipelined_rpcs()
        if isinstance(event, HeartbeatReply):
            if event.term > self.current_term:
                self._update_term(event.term)
                self.leader_id = None
                return self._become_follower(event.term)
            if event.term < self.current_term:
                return []
            return self._heartbeat_rpc_quorum(event.query_index, event.from_)
        if isinstance(event, ConsistentQueryEvent):
            return self._leader_consistent_query(event.from_, event.query_fn)
        if isinstance(event, RequestVoteRpc):
            if event.term > self.current_term:
                if event.candidate_id not in self.cluster:
                    return []
                self._update_term(event.term)
                self.leader_id = None
                return self._become_follower(event.term, next_event=event)
            return [SendRpc(event.candidate_id,
                            RequestVoteResult(term=self.current_term,
                                              vote_granted=False,
                                              from_=self.id))]
        if isinstance(event, PreVoteRpc):
            if event.term > self.current_term:
                if event.candidate_id not in self.cluster:
                    return []
                self._update_term(event.term)
                self.leader_id = None
                return self._become_follower(event.term, next_event=event)
            # enforce leadership (ra_server.erl:793-797)
            return self._make_all_rpcs()
        if isinstance(event, InstallSnapshotRpc):
            # higher term abdicates only for a KNOWN peer
            # (ra_server.erl:662-671); same/lower term is ignored — the
            # reference has no reply clause here and the suite pins it
            # (leader_receives_install_snapshot_rpc: "leader ignores
            # lower term"), unlike stale AERs which get a nack
            if event.term > self.current_term:
                if event.leader_id not in self.cluster:
                    return []
                self._update_term(event.term)
                self.leader_id = None
                return self._become_follower(event.term, next_event=event)
            return []
        if isinstance(event, (AppendEntriesRpc, HeartbeatRpc)):
            if event.term > self.current_term:
                self._update_term(event.term)
                self.leader_id = None
                return self._become_follower(event.term, next_event=event)
            if event.term == self.current_term:
                raise RuntimeError(
                    f"{self.id}: leader saw rpc in same term {event.term}")
            reply = (self._heartbeat_reply()
                     if isinstance(event, HeartbeatRpc)
                     else self._aer_reply(self.current_term, False))
            return [SendRpc(event.leader_id, reply)]
        if isinstance(event, (RequestVoteResult, PreVoteResult)):
            return []
        if isinstance(event, TransferLeadershipEvent):
            return self._leader_transfer(event)
        if isinstance(event, NodeEvent):
            # peer node status drives per-peer replication state
            # (handle_node_status, ra_server.erl:2107-2167)
            changed = False
            for pid, peer in self.cluster.items():
                if pid == self.id or pid.node != event.node:
                    continue
                if event.status == "down" and \
                        peer.status == PeerStatus.NORMAL:
                    peer.status = PeerStatus.DISCONNECTED
                elif event.status == "up" and \
                        peer.status == PeerStatus.DISCONNECTED:
                    peer.status = PeerStatus.NORMAL
                    changed = True
            return self._make_all_rpcs() if changed else []
        if isinstance(event, DownEvent):
            peer = self.cluster.get(event.target)
            if peer is not None and peer.status == PeerStatus.NORMAL:
                peer.status = PeerStatus.DISCONNECTED
            return []
        if isinstance(event, UpEvent):
            # a co-hosted sibling restarted: resume replication NOW —
            # without this edge a restarted follower behind the tail
            # can never catch up (it loses pre-votes and the leader
            # skips DISCONNECTED peers forever)
            peer = self.cluster.get(event.target)
            if peer is not None and \
                    peer.status == PeerStatus.DISCONNECTED:
                peer.status = PeerStatus.NORMAL
                eff = self._make_rpc_for_peer(event.target, peer, 1)
                return [eff] if eff is not None else []
            return []
        if isinstance(event, ElectionTimeout):
            return []
        if isinstance(event, TickEvent):
            return self._tick_leader()
        if isinstance(event, WalUpEvent):
            # resumed from wal_down: push fresh AERs so followers catch up
            # without waiting for the next tick
            return self._make_all_rpcs()
        return []

    def _leader_aer_reply(self, reply: AppendEntriesReply) -> list:
        peer = self.cluster.get(reply.from_)
        if peer is None:
            return []
        if reply.term > self.current_term:
            self._update_term(reply.term)
            self.leader_id = None
            return self._become_follower(reply.term)
        if reply.success and reply.term == self.current_term:
            if peer.status == PeerStatus.DISCONNECTED:
                peer.status = PeerStatus.NORMAL  # hearing from it = alive
            # the confirmed tail must be OUR entry before it can count
            # toward quorum: a follower that adopted this term while
            # still holding a stale suffix of a deposed leader confirms
            # (last_index, last_term) of that suffix via the written-
            # event reply path — advancing match on it would let a
            # divergent entry enter the commit median (the reference
            # checks reply terms only on the failure path,
            # ra_server.erl:477-532; the success path takes last_index
            # unchecked, :430-433 — this is deliberately stricter)
            my_last = self.log.last_index_term().index
            # indexes compacted behind our snapshot are unverifiable, not
            # divergent — trust them like the failure-path repair does
            # (a confirm at/below the snapshot index is always safe to
            # count: the snapshot itself covers it)
            verifiable = reply.last_index >= self.log.first_index()
            if reply.last_index > 0 and verifiable and \
                    self.log.fetch_term(reply.last_index) != reply.last_term:
                # stale-suffix success reply: never advance match on an
                # unverified tail.  Two repair shapes, both of which must
                # generate traffic or the exchange livelocks on repeated
                # identical confirms:
                if reply.last_index > my_last:
                    # follower's durable tail extends past our log (a
                    # deposed leader's surplus): only an EMPTY AER at our
                    # tail truncates it (the follower's reset branch —
                    # resent entries would just be duplicate-dropped)
                    peer.next_index = my_last + 1
                    eff = self._make_rpc_for_peer(reply.from_, peer, 1)
                    return [eff] if eff is not None else []
                # divergence within our range: rewind to the last
                # VERIFIED point; the resend overwrites the follower's
                # conflicting region (its write path truncates from the
                # first conflicting index)
                peer.next_index = peer.match_index + 1
                return self._make_pipelined_rpcs()
            peer.match_index = max(peer.match_index, reply.last_index)
            peer.next_index = max(peer.next_index, reply.next_index)
            effects = self._maybe_promote_peer(reply.from_)
            effects.extend(self._evaluate_quorum())
            effects.extend(self._process_pending_consistent_queries())
            effects.extend(self._make_pipelined_rpcs())
            # if we are no longer in the committed cluster, step down
            # (ra_server.erl:440-453)
            if (self.id not in self.cluster and
                    self.commit_index >= self.cluster_index_term.index):
                self.raft_state = RaftState.STOP
            return effects
        if reply.success:  # stale term reply
            return []
        # success=false: next_index repair (ra_server.erl:477-532)
        t = self.log.fetch_term(reply.last_index)
        if t is None:
            # DESIGN DIVERGENCE: the reference forwards match_index to
            # an UNVERIFIABLE point here (ra_server.erl:489-494).  A
            # refusal can advertise a deposed leader's surplus tail —
            # beyond our own log — and a poisoned match freezes commit
            # evaluation forever: agreed_commit lands on an index whose
            # term the leader cannot verify, so the §5.4.2 gate refuses
            # every subsequent commit (soak seed 181279: leader at tail
            # 36 held match=68 for its only voter, ci frozen while both
            # logs kept growing).  Same rule as the verified success
            # path: unverified points never advance replication state —
            # repair next_index only.
            my_last = self.log.last_index_term().index
            if reply.last_index > my_last:
                # surplus beyond our log: the empty-AER reset at our
                # tail truncates it (the follower's shorter-log branch).
                # Force the probe NOW like the sibling surplus repairs
                # (success path, install-result path): the pipelined
                # sender sees nothing new to send and would defer the
                # truncation to the next tick
                peer.next_index = my_last + 1
                eff = self._make_rpc_for_peer(reply.from_, peer, 1)
                return [eff] if eff is not None else []
            # at/below our snapshot floor: unverifiable here; the
            # snapshot-send path repairs such peers
            peer.next_index = max(reply.next_index, 1)
        elif t == reply.last_term and reply.last_index >= peer.match_index:
            peer.match_index = reply.last_index
            peer.next_index = reply.next_index
        elif reply.last_index < peer.match_index:
            peer.match_index = reply.last_index
            peer.next_index = reply.last_index + 1
        else:
            peer.next_index = max(min(peer.next_index - 1, reply.last_index),
                                  peer.match_index)
        return self._make_pipelined_rpcs()

    def _leader_command(self, cmd: Any, from_: Any) -> list:
        effects = self._leader_append(cmd, from_)
        effects.extend(self._make_pipelined_rpcs())
        return effects

    def _leader_append_batch(self, commands: tuple,
                             images: Optional[tuple] = None) -> list:
        """Drain one {commands, Batch} flush into the log as RUNS of
        plain user commands: one contiguous-index Entry run,
        ONE log batch-append (= one memtable lock cycle + one WAL
        fan-in submit) per run, with per-command bookkeeping reduced to
        the reply-mode/trace checks.  Anything that is not a plain
        UserCommand (membership ops, machine-internal commands) closes
        the run and takes the per-command append path — those are rare
        and carry their own effect logic.

        ``images`` — codec payload images aligned with
        ``commands``, shipped by the wire receiver: the run's images
        ride into append_batch as the durable payloads, so a command
        that arrived over TCP is never re-encoded at the leader."""
        effects: list = []
        run: list = []
        run_imgs: Optional[list] = [] if images is not None else None
        append_batch = self._log_append_batch
        log = self.log

        def _flush_run() -> None:
            if not run:
                return
            idx0 = log.next_index()
            term = self.current_term
            entries = [Entry(idx0 + i, term, cmd)
                       for i, cmd in enumerate(run)]
            if append_batch is not None:
                append_batch(entries, run_imgs if run_imgs else None)
            else:
                for e in entries:
                    log.append(e)
            uid = self.cfg.uid
            for i, cmd in enumerate(run):
                if cmd.trace is not None:
                    # the trace ctx -> (uid, idx) join point
                    record("cmd.append", trace=cmd.trace, uid=uid,
                           idx=idx0 + i, term=term, server=str(self.id))
                if cmd.reply_mode is ReplyMode.AFTER_LOG_APPEND and \
                        cmd.from_ is not None:
                    effects.append(Reply(cmd.from_,
                                         CommandResult(idx0 + i, term,
                                                       None, self.id)))
            run.clear()
            if run_imgs is not None:
                run_imgs.clear()

        for i, cmd in enumerate(commands):
            if type(cmd) is UserCommand:
                run.append(cmd)
                if run_imgs is not None:
                    run_imgs.append(images[i])
            else:
                _flush_run()
                effects.extend(self._leader_append(cmd, None))
        _flush_run()
        return effects

    def _leader_append(self, cmd: Any, from_: Any) -> list:
        """append_log_leader (ra_server.erl:2798-2915): join/leave commands
        become '$ra_cluster_change' appends; cluster changes are refused
        while one is in flight."""
        effects: list = []
        if isinstance(cmd, JoinCommand):
            if not self.cluster_change_permitted:
                return self._defer_or_refuse(cmd, from_, effects)
            if cmd.server_id in self.cluster:
                if from_ is not None:
                    effects.append(Reply(from_, ErrorResult("already_member",
                                                            self.id)))
                return effects
            new_cluster = {sid: (p.membership, p.promote_target)
                           for sid, p in self.cluster.items()}
            target = 0
            if cmd.membership == Membership.PROMOTABLE:
                target = self.log.next_index()
            new_cluster[cmd.server_id] = (cmd.membership, target)
            return self._append_cluster_change(new_cluster, cmd, from_,
                                               effects)
        if isinstance(cmd, LeaveCommand):
            if not self.cluster_change_permitted:
                return self._defer_or_refuse(cmd, from_, effects)
            if cmd.server_id not in self.cluster:
                if from_ is not None:
                    effects.append(Reply(from_, ErrorResult("not_member",
                                                            self.id)))
                return effects
            new_cluster = {sid: (p.membership, p.promote_target)
                           for sid, p in self.cluster.items()
                           if sid != cmd.server_id}
            if not any(ms == Membership.VOTER
                       for ms, _t in new_cluster.values()):
                # refusing is stricter than the reference but saves the
                # cluster: a voterless config is permanently dead — no
                # member can stand for election, so no later change can
                # ever repair it (found by the membership fuzz: leave of
                # the last voter while the rest were still promotable)
                if from_ is not None:
                    effects.append(Reply(from_, ErrorResult(
                        "last_voter", self.id)))
                return effects
            return self._append_cluster_change(new_cluster, cmd, from_,
                                               effects)
        # plain commands: attach from_ for the consensus reply
        if from_ is not None and hasattr(cmd, "from_"):
            cmd = replace(cmd, from_=from_)
        idx = self.log.next_index()
        entry = Entry(idx, self.current_term, cmd)
        self.log.append(entry)
        if getattr(cmd, "trace", None) is not None:
            # the trace ctx -> (uid, idx) join point: WAL/commit hop
            # events are idx-keyed, ra_trace stitches them through this
            record("cmd.append", trace=cmd.trace, uid=self.cfg.uid,
                   idx=idx, term=self.current_term, server=str(self.id))
        reply_mode = getattr(cmd, "reply_mode", None)
        if reply_mode == ReplyMode.AFTER_LOG_APPEND and from_ is not None:
            effects.append(Reply(from_, CommandResult(idx, self.current_term,
                                                      None, self.id)))
        return effects

    def _defer_or_refuse(self, cmd: Any, from_: Any, effects: list) -> list:
        if from_ is not None:
            effects.append(Reply(from_, ErrorResult(
                "cluster_change_not_permitted", self.id)))
        return effects

    def _append_cluster_change(self, cluster_spec: dict, cmd: Any,
                               from_: Any, effects: list) -> list:
        spec = tuple((sid, ms[0]) for sid, ms in cluster_spec.items())
        change = ClusterChangeCommand(
            cluster=spec, reply_mode=getattr(cmd, "reply_mode",
                                             ReplyMode.AWAIT_CONSENSUS),
            from_=from_)
        idx = self.log.next_index()
        prev = (self.cluster_index_term,
                tuple((sid, p.membership) for sid, p in self.cluster.items()))
        entry = Entry(idx, self.current_term, change)
        self.log.append(entry)
        # the new cluster takes effect immediately on append
        # (pre-commit, ra_server.erl append_cluster_change)
        new_cluster = {}
        for sid, (membership, target) in cluster_spec.items():
            peer = Peer(membership=membership, promote_target=target)
            new_cluster[sid] = peer
        self._set_cluster(new_cluster)
        self.cluster_change_permitted = False
        self.cluster_index_term = IdxTerm(idx, self.current_term)
        self.previous_cluster = prev
        return effects

    def _maybe_promote_peer(self, peer_id: ServerId) -> list:
        """Auto-promote a promotable non-voter that caught up
        (ra_server.erl:3218-3293)."""
        peer = self.cluster.get(peer_id)
        if (peer is None or peer.membership != Membership.PROMOTABLE or
                peer.match_index < peer.promote_target or
                not self.cluster_change_permitted):
            return []
        new_cluster = {sid: ((p.membership if sid != peer_id
                              else Membership.VOTER), p.promote_target)
                       for sid, p in self.cluster.items()}
        return self._append_cluster_change(
            new_cluster, JoinCommand(peer_id, reply_mode=ReplyMode.NOREPLY),
            None, [])

    # -- quorum arithmetic: THE kernel (ra_server.erl:2941-2993) ----------

    def match_indexes(self) -> list:
        """Voter match indexes; self is represented by last *written*
        (ra_server.erl:2977-2987) — but ONLY while self is a voter of
        the current configuration.  A leader removed by its own
        in-flight '$ra_leave' serves until the change commits
        (dissertation §4.2.2), and committing requires a majority of
        the NEW config: counting its own log in place of a new-config
        voter lets it "commit" entries a real quorum never held (found
        by the combined fuzz: the removed leader committed its own
        removal at an index one new-config voter was missing, wedging a
        follower with applied > tail).  The reference includes own
        unconditionally and shares the hazard."""
        lw = self.log.last_written()
        snap = self.log.snapshot_index_term()
        own = max(lw.index, snap.index)
        self_peer = self.cluster.get(self.id)
        idxs = []
        if self_peer is not None and \
                self_peer.membership == Membership.VOTER:
            idxs.append(own)
        for pid, peer in self.cluster.items():
            if pid == self.id:
                continue
            if peer.membership != Membership.VOTER:
                continue
            idxs.append(peer.match_index)
        # degenerate safety net: no voters visible (transient states) —
        # fall back to own so the median is defined
        return idxs or [own]

    @staticmethod
    def agreed_commit(indexes: list) -> int:
        """Quorum-agreed index: sort desc, take element trunc(n/2)+1 (1-based)
        (ra_server.erl:2989-2993).  This is the scalar oracle for the
        batched kernel in ra_tpu_torch.ops.quorum."""
        s = sorted(indexes, reverse=True)
        return s[len(s) // 2]

    def _increment_commit_index(self) -> None:
        potential = self.agreed_commit(self.match_indexes())
        if potential <= self.commit_index:
            return
        # §5.4.2: only commit entries from the current term
        t = self.log.fetch_term(potential)
        if t == self.current_term:
            self.commit_index = potential
            # idx-keyed commit hop (one event per ADVANCE, not per
            # entry): ra_trace resolves a command's commit time as the
            # first advance at or past its append idx
            record("cmd.commit", uid=self.cfg.uid, idx=potential,
                   term=self.current_term)

    def _evaluate_quorum(self) -> list:
        ci0 = self.commit_index
        self._increment_commit_index()
        effects: list = []
        if self.commit_index > ci0:
            effects.append(AuxEffect("eval"))
        self._apply_to(self.commit_index, effects)
        return effects

    # -- the apply fold (ra_server.erl:2557-2744) -------------------------

    def _apply_to(self, apply_to: int, effects: list,
                  suppress: bool = False) -> None:
        if apply_to <= self.last_applied:
            return
        if self.machine_version < self.effective_machine_version:
            return
        last_idx = self.log.last_index_term().index
        to = min(last_idx, apply_to)
        notifys: dict = {}
        t0 = time.monotonic()
        entries = self.log.read_range(self.last_applied + 1, to)
        batch_fn = self.effective_machine.apply_batch
        # applied-notification routing is leader-only (followers drop
        # Notify effects in _filter_follower_effects) — skip collecting
        # what would be thrown away; from_-carrying replies
        # (member-replier await_consensus) are preserved regardless
        collect_notify = self.raft_state == RaftState.LEADER or \
            (self.raft_state == RaftState.AWAIT_CONDITION and
             self.condition is not None and
             self.condition.transition_to == RaftState.LEADER)
        i = 0
        n = len(entries)
        while i < n:
            if self.machine_version < self.effective_machine_version:
                break  # version gate: cannot apply further (same stop
                # condition _apply_one enforces per entry)
            entry = entries[i]
            if batch_fn is None or type(entry.command) is not UserCommand:
                self._apply_one(entry, effects, notifys, suppress)
                i += 1
                # the apply may have bumped the effective machine (a
                # noop version bump mid-range): re-resolve the batch fn
                batch_fn = self.effective_machine.apply_batch
                continue
            # batched fold: hand the machine the contiguous
            # same-term run of plain user commands in ONE call; replies
            # come back in order and feed the same notify plumbing
            j = i + 1
            term = entry.term
            while j < n and entries[j].term == term and \
                    type(entries[j].command) is UserCommand:
                j += 1
            run = entries[i:j]
            self._apply_user_run(run, batch_fn, effects, notifys,
                                 suppress, collect_notify)
            i = j
        self.commit_latency = time.monotonic() - t0
        self.log.note_applied(self.last_applied)
        if notifys and not suppress:
            for to_pid, corrs in notifys.items():
                effects.append(Notify(to_pid, tuple(corrs)))

    def _apply_user_run(self, run: list, batch_fn, effects: list,
                        notifys: dict, suppress: bool,
                        collect_notify: bool = True) -> None:
        """Apply one contiguous run of plain user commands through the
        machine's batched fold.  Exactly order-equivalent to folding
        apply() over the run (the apply_batch contract); the per-command
        tail work (trace hops, reply/notify routing) is reduced to the
        cheapest possible checks — and reply routing is skipped
        entirely for commands that cannot owe one (no from_, no
        notify_to), which on followers is every pipelined command."""
        first = run[0]
        meta = ApplyMeta(index=first.index, term=first.term,
                         machine_version=self.effective_machine_version)
        result = batch_fn(meta, [e.command.data for e in run],
                          self.machine_state)
        if len(result) == 3:
            self.machine_state, replies, app_effs = result
        else:
            self.machine_state, replies = result
            app_effs = []
        self.last_applied = run[-1].index
        if suppress:
            return  # recovery replay: not a live apply hop
        if app_effs:
            effects.extend(app_effs)
        uid = self.cfg.uid
        for e, reply in zip(run, replies):
            cmd = e.command
            if cmd.trace is not None:
                record("cmd.apply", trace=cmd.trace, uid=uid,
                       idx=e.index, server=str(self.id))
            if cmd.from_ is not None or \
                    (collect_notify and cmd.notify_to is not None):
                self._add_reply(cmd, e.index, e.term, reply, effects,
                                notifys)

    def _apply_one(self, entry: Entry, effects: list, notifys: dict,
                   suppress: bool) -> None:
        idx, term, cmd = entry
        if self.machine_version < self.effective_machine_version:
            return  # cannot apply further (version gate)
        if isinstance(cmd, UserCommand):
            meta = ApplyMeta(index=idx, term=term,
                             machine_version=self.effective_machine_version,
                             from_=cmd.from_, reply_mode=cmd.reply_mode)
            result = self.effective_machine.apply(meta, cmd.data,
                                                  self.machine_state)
            if len(result) == 3:
                self.machine_state, reply, app_effs = result
            else:
                self.machine_state, reply = result
                app_effs = []
            self.last_applied = idx
            if suppress:
                return  # recovery replay: not a live apply hop
            if cmd.trace is not None:
                record("cmd.apply", trace=cmd.trace, uid=self.cfg.uid,
                       idx=idx, server=str(self.id))
            effects.extend(app_effs)
            self._add_reply(cmd, idx, term, reply, effects, notifys)
            return
        if isinstance(cmd, NoopCommand):
            self._apply_noop(entry, cmd, effects, suppress)
            return
        if isinstance(cmd, ClusterChangeCommand):
            if (idx > self.cluster_index_term.index and
                    term >= self.cluster_index_term.term):
                # recovery path: actually apply the change (cit before
                # _set_cluster — the membership cache's config fallback
                # keys on cit==0)
                self.cluster_index_term = IdxTerm(idx, term)
                self._set_cluster(dict_from_cluster_spec(cmd.cluster))
            self.cluster_change_permitted = True
            self.last_applied = idx
            if not suppress:
                self._add_reply(cmd, idx, term, "ok", effects, notifys)
            return
        if isinstance(cmd, ClusterDeleteCommand):
            self.last_applied = idx
            self.raft_state = RaftState.DELETE_AND_TERMINATE
            if not suppress:
                self._add_reply(cmd, idx, term, "ok", effects, notifys)
                effects.extend(self.machine.state_enter("eol",
                                                        self.machine_state))
            return
        # unknown command: count as applied
        self.last_applied = idx

    def _apply_noop(self, entry: Entry, cmd: NoopCommand, effects: list,
                    suppress: bool) -> None:
        idx, term, _ = entry
        if term == self.current_term:
            self.cluster_change_permitted = True
        next_ver = cmd.machine_version
        if next_ver > self.effective_machine_version:
            if self.machine_version >= next_ver:
                old_ver = self.effective_machine_version
                self.effective_machine_version = next_ver
                self.machine_versions.insert(0, (idx, next_ver))
                self.effective_machine = self.machine.which_module(next_ver)
                # apply the version-bump as a pseudo user command
                # (ra_server.erl:2695-2712)
                meta = ApplyMeta(index=idx, term=term,
                                 machine_version=next_ver)
                result = self.effective_machine.apply(
                    meta, ("machine_version", old_ver, next_ver),
                    self.machine_state)
                self.machine_state = result[0]
                if len(result) == 3 and not suppress:
                    effects.extend(result[2])
                self.last_applied = idx
            else:
                # cannot understand the new version: stop applying
                self.effective_machine_version = next_ver
        else:
            self.last_applied = idx

    def _add_reply(self, cmd: Any, idx: int, term: int, reply: Any,
                   effects: list, notifys: dict) -> None:
        mode = getattr(cmd, "reply_mode", None)
        if mode == ReplyMode.AWAIT_CONSENSUS and \
                getattr(cmd, "from_", None) is not None:
            replier = getattr(cmd, "reply_from", None) or "leader"
            effects.append(Reply(cmd.from_,
                                 CommandResult(idx, term, reply, self.id),
                                 replier=replier))
        elif mode == ReplyMode.NOTIFY and \
                getattr(cmd, "notify_to", None) is not None:
            notifys.setdefault(cmd.notify_to, []).append(
                (cmd.correlation, reply))

    # -- replication rpcs (ra_server.erl:1862-2016) ------------------------

    def _make_pipelined_rpcs(self) -> list:
        """Per-peer pipelining with flow control: in-flight bounded by
        max_pipeline_count, batches by max_append_entries_batch."""
        effects: list = []
        next_log_idx = self.log.next_index()
        # one read memo per send wave: caught-up peers want the SAME
        # range, so the second peer's AER reuses the first's entries +
        # payloads instead of re-reading the log
        memo: dict = {}
        for pid, peer in self.cluster.items():
            if pid == self.id or peer.status != PeerStatus.NORMAL:
                continue
            if not (peer.next_index < next_log_idx or
                    peer.commit_index_sent < self.commit_index):
                continue
            in_flight = peer.next_index - peer.match_index - 1
            if in_flight >= self.cfg.max_pipeline_count:
                continue
            batch = min(self.cfg.max_append_entries_batch,
                        self.cfg.max_pipeline_count - in_flight)
            eff = self._make_rpc_for_peer(pid, peer, batch, memo)
            if eff is not None:
                peer.commit_index_sent = self.commit_index
                effects.append(eff)
        return effects

    def _make_all_rpcs(self) -> list:
        """Empty/heartbeat AERs to all normal-status peers (make_all_rpcs)."""
        effects: list = []
        effects.extend(self._update_heartbeat_rpcs())
        for pid, peer in self.cluster.items():
            if pid == self.id or peer.status != PeerStatus.NORMAL:
                continue
            eff = self._make_rpc_for_peer(pid, peer, 1)
            if eff is not None:
                effects.append(eff)
        return effects

    def _make_rpc_for_peer(self, pid: ServerId, peer: Peer,
                           batch: int,
                           memo: Optional[dict] = None) -> Optional[Any]:
        prev_idx = peer.next_index - 1
        if prev_idx == 0 and self.log.snapshot_index_term().index > 0:
            # peer wants the log from the very start but our prefix is
            # compacted behind a snapshot: entries 1..snap are gone, so
            # prev=0 would ship a gapped batch (fetch_term(PrevIdx)
            # undefined ∧ PrevIdx < snapshot idx, ra_server.erl:1962-1981)
            peer.status = PeerStatus.SENDING_SNAPSHOT
            peer.snapshot_started = time.monotonic()
            peer.snapshot_sender = self._next_snapshot_token()
            return SendSnapshot(pid, (self.id, self.current_term),
                                token=peer.snapshot_sender)
        prev_term = self.log.fetch_term(prev_idx) if prev_idx > 0 else 0
        if prev_term is None:
            snap = self.log.snapshot_index_term()
            if snap.index == prev_idx:
                prev_term = snap.term
            else:
                # entry compacted away: peer needs a snapshot
                # (ra_server.erl:1962-1981)
                peer.status = PeerStatus.SENDING_SNAPSHOT
                peer.snapshot_started = time.monotonic()
                peer.snapshot_sender = self._next_snapshot_token()
                return SendSnapshot(pid, (self.id, self.current_term),
                                    token=peer.snapshot_sender)
        last_idx = self.log.last_index_term().index
        to = min(last_idx, prev_idx + batch)
        entries: tuple = ()
        payloads = None
        if to > prev_idx:
            # one-lock batched read WITH the already-encoded durable
            # images when the range is memtable-resident (the common
            # steady-state case) — bounded by the frame byte budget;
            # catch-up ranges that left the memtable fall back to the
            # plain read and followers re-encode
            cached = memo.get((prev_idx + 1, to)) \
                if memo is not None else None
            if cached is not None:
                entries, payloads = cached
            else:
                got = self._log_read_payloads(
                    prev_idx + 1, to,
                    self.cfg.max_append_entries_bytes) \
                    if self._log_read_payloads is not None else None
                if got is not None:
                    entries = tuple(got[0])
                    payloads = tuple(got[1])
                else:
                    entries = tuple(self.log.read_range(prev_idx + 1,
                                                        to))
                    payloads = None
                if memo is not None:
                    memo[(prev_idx + 1, to)] = (entries, payloads)
            if entries:
                peer.next_index = entries[-1].index + 1
                n = len(entries)
                self.stats["aer_batches_sent"] += 1
                self.stats["aer_batch_entries"] += n
                self._aer_batch_sizes.append(n)
                # ONE event per replication batch (never per entry):
                # the wire-batching health signal (RA06)
                record("rpc.batch", to=str(pid), n=n,
                       bytes=sum(map(len, payloads))
                       if payloads is not None else -1)
        return SendRpc(pid, AppendEntriesRpc(
            term=self.current_term, leader_id=self.id,
            prev_log_index=prev_idx, prev_log_term=prev_term or 0,
            leader_commit=self.commit_index, entries=entries,
            payloads=payloads))

    # -- consistent queries (ra_server.erl:3032-3190) ----------------------

    def _leader_consistent_query(self, from_: Any, query_fn: Any) -> list:
        if not self.cluster_change_permitted:
            # a new leader must commit its noop first (:3174-3190)
            self.pending_consistent_queries.append((from_, query_fn,
                                                    self.commit_index))
            return []
        return self._make_heartbeat_rpcs(from_, query_fn, self.commit_index)

    def _make_heartbeat_rpcs(self, from_: Any, query_fn: Any,
                             commit_index: int) -> list:
        self.query_index += 1
        self.queries_waiting_heartbeats.append(
            (self.query_index, from_, query_fn, commit_index))
        effects: list = []
        for pid, peer in self.cluster.items():
            if pid == self.id or peer.membership != Membership.VOTER:
                continue
            effects.append(SendRpc(pid, HeartbeatRpc(
                query_index=self.query_index, term=self.current_term,
                leader_id=self.id)))
        if self._voter_count() == 1:
            effects.extend(self._apply_ready_queries())
        return effects

    def _update_heartbeat_rpcs(self) -> list:
        if not self.queries_waiting_heartbeats:
            return []
        effects: list = []
        for pid, peer in self.cluster.items():
            if pid == self.id or peer.membership != Membership.VOTER:
                continue
            effects.append(SendRpc(pid, HeartbeatRpc(
                query_index=self.query_index, term=self.current_term,
                leader_id=self.id)))
        return effects

    def _heartbeat_rpc_quorum(self, reply_qidx: int,
                              from_peer: ServerId) -> list:
        peer = self.cluster.get(from_peer)
        if peer is None:
            return []
        peer.query_index = max(peer.query_index, reply_qidx)
        return self._apply_ready_queries()

    def _agreed_query_index(self) -> int:
        # same voter gate as match_indexes: a leader removed by its
        # in-flight change must not count its own confirmation toward
        # the new config's heartbeat quorum, or a linearizable read can
        # be certified by a minority of the real voters
        self_peer = self.cluster.get(self.id)
        idxs = []
        if self_peer is not None and \
                self_peer.membership == Membership.VOTER:
            idxs.append(self.query_index)
        for pid, peer in self.cluster.items():
            if pid == self.id or peer.membership != Membership.VOTER:
                continue
            idxs.append(peer.query_index)
        return self.agreed_commit(idxs or [self.query_index])

    def _apply_ready_queries(self) -> list:
        agreed = self._agreed_query_index()
        ready = [q for q in self.queries_waiting_heartbeats if q[0] <= agreed]
        if not ready:
            return []
        self.queries_waiting_heartbeats = [
            q for q in self.queries_waiting_heartbeats if q[0] > agreed]
        effects: list = []
        for _qidx, from_, query_fn, _ci in ready:
            result = query_fn(self.machine_state)
            effects.append(Reply(from_, CommandResult(
                self.last_applied, self.current_term, result, self.id)))
        return effects

    def _process_pending_consistent_queries(self) -> list:
        if not self.pending_consistent_queries or \
                not self.cluster_change_permitted:
            return []
        pending, self.pending_consistent_queries = \
            self.pending_consistent_queries, []
        effects: list = []
        for from_, query_fn, ci in pending:
            effects.extend(self._make_heartbeat_rpcs(from_, query_fn, ci))
        return effects

    # -- leader transfer (ra_server.erl:806-828) ---------------------------

    def _leader_transfer(self, event: TransferLeadershipEvent) -> list:
        target = event.target
        if target == self.id:
            if event.from_ is not None:
                return [Reply(event.from_, "already_leader")]
            return []
        if target not in self.cluster:
            if event.from_ is not None:
                return [Reply(event.from_,
                              ErrorResult("unknown_member", self.id))]
            return []
        self._transfer_target = target
        self.condition = Condition(
            predicate=_transfer_leadership_predicate,
            transition_to=RaftState.LEADER,
            timeout_ms=self.cfg.election_timeout_ms,
            timeout_effects=[])
        self.raft_state = RaftState.AWAIT_CONDITION
        effects: list = [SendRpc(target, TransferLeadershipEvent(target))]
        if event.from_ is not None:
            effects.append(Reply(event.from_, "ok"))
        return effects

    # -- await_condition (ra_server.erl:946-1010 in proc; core predicates) -

    def enter_wal_down(self) -> list:
        """A log write raised WalDown: park in await_condition until the
        supervisor restarts the WAL and the log surfaces a WalUpEvent,
        then resume the previous role.  The reference keeps the server
        alive through exactly this state while ra_log_wal is supervised
        back up (ra_server.erl:538-554); killing the server instead would
        convert a recoverable infra fault into data-plane loss.

        The failed entry is NOT lost: DurableLog._put records it in the
        memtable before submitting to the WAL, and wal_restarted() resends
        everything above last_written to the new incarnation."""
        if self.raft_state in (RaftState.STOP,
                               RaftState.DELETE_AND_TERMINATE,
                               RaftState.AWAIT_CONDITION):
            return []
        back = self.raft_state if self.raft_state in (
            RaftState.LEADER, RaftState.FOLLOWER) else RaftState.FOLLOWER
        self.condition = Condition(
            predicate=_wal_up_predicate,
            transition_to=back,
            timeout_ms=self.cfg.await_condition_timeout_ms,
            timeout_effects=[])
        self.raft_state = RaftState.AWAIT_CONDITION
        # bounded stay: if the supervisor never revives the WAL the
        # timeout path re-enters the previous role (whose next write
        # re-parks) rather than wedging here forever
        return [StartElectionTimeout("medium")]

    def _handle_await_condition(self, event: Any) -> list:
        if isinstance(event, ElectionTimeout):
            cond = self.condition
            if cond is not None and cond.predicate is _wal_up_predicate \
                    and not getattr(self.log, "wal_is_up",
                                    lambda: True)():
                # WAL still dead: bouncing out would re-park on the next
                # write and lose the postponed backlog mid-replay — stay
                # parked until the supervisor finishes (clients time out
                # on their own clocks, same as the reference's hold)
                return [StartElectionTimeout("medium")]
            # condition timed out
            self.condition = None
            self.raft_state = cond.transition_to if cond else \
                RaftState.FOLLOWER
            effs = list(cond.timeout_effects) if cond else []
            effs.append(StartElectionTimeout("medium"))
            effs.extend(self._replay_condition_pending())
            return effs
        if isinstance(event, RequestVoteRpc):
            # a vote request exits the wait: revert to follower and
            # re-dispatch it there (ra_server.erl:1453-1454).  Denying
            # while parked starves elections — e.g. after a leader's
            # self-removal commits, the survivors parked on its log gap
            # would veto every candidacy forever (found by the
            # membership fuzz).  A parked LEADER, however, applies the
            # same gates an active leader does (:1233-1243): a stale
            # same/lower-term request is denied in place and a
            # non-member candidate is ignored — otherwise a removed
            # node replaying an old candidacy would depose the parked
            # leader, erroring its waiting queries and aborting
            # snapshot sends an active leader would have kept.
            if self.condition is not None and \
                    self.condition.transition_to == RaftState.LEADER:
                if event.term <= self.current_term:
                    return [SendRpc(event.candidate_id,
                                    RequestVoteResult(
                                        term=self.current_term,
                                        vote_granted=False,
                                        from_=self.id))]
                if event.candidate_id not in self.cluster:
                    return []
                pre = self._leader_teardown()
            else:
                pre = []
            self.condition = None
            self.raft_state = RaftState.FOLLOWER
            return (pre + [NextEvent(event)] +
                    self._replay_condition_pending())
        if isinstance(event, PreVoteRpc):
            # a HIGHER-term pre-vote exits the wait like a vote request
            # does: a parked LEADER that merely adopted the term in
            # place would later resume as leader of a term it never won
            # (two leaders in one term)
            if event.term > self.current_term:
                if self.condition is not None and \
                        self.condition.transition_to == RaftState.LEADER:
                    if event.candidate_id not in self.cluster:
                        return []    # non-member: same gate as :1246
                    pre = self._leader_teardown()
                else:
                    pre = []
                self.condition = None
                self.raft_state = RaftState.FOLLOWER
                return (pre + [NextEvent(event)] +
                        self._replay_condition_pending())
            # same-term pre-votes are answered IN PLACE — granting one
            # does not exit the wait (ra_server.erl:1455-1456).  Like
            # the follower path, no granter-side membership gate: real
            # votes are equally permissive, so a pre-vote grant here
            # cannot lure a candidate into an election it then loses.
            return self._process_pre_vote(event)
        if isinstance(event, WrittenEvent):
            self.log.handle_written(event)
            if self.condition is not None and \
                    self.condition.transition_to == RaftState.LEADER:
                # a parked leader (wal_down/transfer) still counts its own
                # confirms toward quorum — otherwise a confirm consumed
                # here is never re-evaluated and committed-but-unacked
                # clients hang until the next unrelated write
                effs = self._evaluate_quorum()
                effs.extend(self._process_pending_consistent_queries())
                return effs
            if self.leader_id is not None and \
                    self.condition is not None and \
                    self.condition.transition_to == RaftState.FOLLOWER:
                return [SendRpc(self.leader_id,
                                self._aer_reply(self.current_term, True))]
            return []
        cond = self.condition
        if cond is not None and cond.predicate(event, self):
            self.condition = None
            self.raft_state = cond.transition_to
            # the satisfying event re-dispatches in the new state, then the
            # postponed backlog replays in arrival order (gen_statem's
            # postpone-retry on state change, ra_server_proc.erl:946-1010)
            return [NextEvent(event)] + self._replay_condition_pending()
        # An unsatisfying AER during the CATCH-UP park is dropped with a
        # refusal to ITS sender, not postponed (the reference's await
        # catch-all drops such messages, ra_server.erl:1766-1775).  Two
        # liveness holes otherwise (soak seed 140855, anchored
        # in-suite): postponed AERs re-park on replay AHEAD of fresh
        # traffic — each condition kick consumes exactly one stale head
        # while a live leader's heartbeats queue behind, a treadmill
        # that never drains — and the park-time refusal stays addressed
        # to the leader of the PARKING term, so a newer leader would
        # never learn this follower's position.  The refusal carries
        # the sender's term when current (term adoption itself waits
        # for an entry we can use) and our own term against a stale
        # sender, exactly as a live follower would answer.  Safe: a
        # refusal only resets the sender's next_index; AERs carry no
        # client state to lose and leaders resend.
        if isinstance(event, AppendEntriesRpc) and cond is not None and \
                cond.predicate is _follower_catchup_predicate:
            reply_term = max(event.term, self.current_term)
            return [SendRpc(event.leader_id,
                            self._aer_reply(reply_term, False))]
        # postpone: buffer the event for replay when the condition exits
        # (ra_server_proc postpones via gen_statem; dropping would force a
        # leader resend round-trip).  Periodic ticks are not worth keeping.
        if not isinstance(event, TickEvent):
            self.condition_pending.append(event)
            if len(self.condition_pending) > MAX_CONDITION_PENDING:
                evicted = self.condition_pending.popleft()
                frm = getattr(evicted, "from_", None)
                if frm is not None:
                    # an evicted client call must not hang silently —
                    # bounce it the way the pre-postpone path did
                    return [Reply(frm, ErrorResult("not_leader",
                                                   self.leader_id))]
        return []

    def _replay_condition_pending(self) -> list:
        """Drain events postponed during await_condition as NextEvents —
        they re-dispatch in the state the condition exited into."""
        pending = list(self.condition_pending)
        self.condition_pending.clear()
        return [NextEvent(e) for e in pending]

    # -- tick (ra_server.erl tick/1 + proc tick handling) ------------------

    def _tick(self) -> list:
        effects = list(self.machine.tick(time.time(), self.machine_state))
        effects.extend(self.log.tick(time.monotonic() * 1000.0))
        # lazily persist apply progress so recovery can dedup effects
        # (ra_log_meta last_applied; the reference batches through dets
        # with auto_save 5s, ra_log_meta.erl:32,53).  Throttled to the
        # same order — a full meta rewrite per 100ms tick was ~15% of
        # busy CPU under the classic bench; staleness only costs
        # effect-dedup precision on recovery.
        now = time.monotonic()
        if self.last_applied > self._persisted_last_applied and \
                now - self._last_meta_save >= 2.5:
            self._last_meta_save = now
            self.log.store_meta(sync=False, last_applied=self.last_applied)
            self._persisted_last_applied = self.last_applied
        return _filter_follower_effects(effects) \
            if self.raft_state != RaftState.LEADER else effects

    def flush_applied_watermark(self) -> None:
        """Persist the lazy last_applied watermark NOW — the clean-stop
        path (the reference's dets ra_log_meta flushes on close too).
        Recovery after a clean stop then suppresses every already-seen
        machine effect instead of replaying the up-to-2.5s-stale
        suffix; a crash still only costs effect-dedup precision."""
        if self.last_applied > self._persisted_last_applied:
            self.log.store_meta(sync=False, last_applied=self.last_applied)
            self._persisted_last_applied = self.last_applied

    def _next_snapshot_token(self) -> int:
        self._snapshot_token = getattr(self, "_snapshot_token", 0) + 1
        return self._snapshot_token

    #: give up on an unacknowledged snapshot transfer after this long —
    #: the functional stand-in for the reference's snapshot_sender DOWN
    #: (peer_snapshot_process_exited, ra_server.erl handle_down): resets
    #: the peer so the pipeline retries (possibly re-sending)
    SNAPSHOT_SEND_TIMEOUT_S = 5.0

    def _tick_leader(self) -> list:
        effects = self._tick()
        now = time.monotonic()
        for peer in self.cluster.values():
            if peer.status == PeerStatus.SENDING_SNAPSHOT and \
                    now - peer.snapshot_started > \
                    self.SNAPSHOT_SEND_TIMEOUT_S:
                peer.status = PeerStatus.NORMAL
                peer.snapshot_sender = None
        # refresh peers (periodic empty AERs stand in for ra's aten-driven
        # liveness; ra sends no idle heartbeats, INTERNALS.md:291-328)
        effects.extend(self._make_all_rpcs())
        return effects

    # -- aux state machinery (ra_machine handle_aux + ra_aux accessors) ----

    def handle_aux(self, kind: str, msg: Any, from_: Any = None) -> list:
        """Route an aux command/eval into the machine's handle_aux
        (ra_server.erl handle_aux dispatch; ra_aux gives the callback
        read access to server internals via ``internal=self``)."""
        result = self.effective_machine.handle_aux(
            self.raft_state.value, kind, msg, self.aux_state, self)
        effects: list = []
        reply = None
        if isinstance(result, tuple):
            if len(result) >= 1:
                self.aux_state = result[0]
            if len(result) >= 2 and result[1] is not None:
                effects = list(result[1]) if \
                    isinstance(result[1], (list, tuple)) else []
            if len(result) >= 3:
                reply = result[2]
        if from_ is not None and not any(isinstance(e, Reply)
                                         for e in effects):
            effects.append(Reply(from_, reply if reply is not None
                                 else "ok"))
        return effects

    # -- machine effects executed in the core (release_cursor etc.) --------

    def _cluster_spec_at(self, idx: int) -> tuple:
        """The configuration in force at log index ``idx``: the live
        view when the recorded change is at/below idx; else
        previous_cluster when ITS change index is at/below idx (one
        change in flight at a time makes it the config between the two
        newest changes); else the newest change found scanning the log
        down to the snapshot, whose meta cluster is the base case."""
        if self.cluster_index_term.index <= idx:
            return tuple((sid, p.membership)
                         for sid, p in self.cluster.items())
        if self.previous_cluster is not None and \
                self.previous_cluster[0].index <= idx:
            return self.previous_cluster[1]
        # fetch downward with an early break — the wanted change is
        # typically near idx; a forward read_range would materialize
        # the whole prefix first.  The memo bounds the scan: snapshot/
        # checkpoint effects arrive with monotonically growing indexes,
        # and everything at/below an earlier release cursor is committed
        # prefix, so on a change-free log the common case is O(new
        # entries since the last call), not O(log length).
        lo = self.log.first_index()
        cached = self._spec_cache
        # the memo only narrows the scan while the log still covers
        # (cached_idx, idx] in full — once the snapshot floor passes the
        # cached index a change may hide under the snapshot, and the
        # meta fallback below (newer information) must win instead
        use_cache = (cached is not None and cached[0] <= idx and
                     lo <= cached[0] + 1)
        if use_cache:
            lo = cached[0] + 1
        for i in range(idx, lo - 1, -1):
            e = self.log.fetch(i)
            if e is not None and isinstance(e.command,
                                            ClusterChangeCommand):
                spec = tuple(e.command.cluster)
                self._spec_cache = (idx, spec)
                return spec
        if use_cache:
            self._spec_cache = (idx, cached[1])
            return cached[1]
        meta = self.log.snapshot_meta()
        if meta is not None and meta.index <= idx:
            spec = tuple(meta.cluster)
            self._spec_cache = (idx, spec)
            return spec
        return tuple((sid, p.membership)
                     for sid, p in self.cluster.items())

    def _machine_version_at(self, idx: int) -> int:
        """The effective machine version at log index ``idx`` — the
        newest bump at or below it (machine_versions is newest-first).
        Stamping the LIVE version would mis-label a snapshot taken at
        an index below a just-applied bump (index_machine_version,
        ra_server.erl parity; the same stamp-at-index rule as
        _cluster_spec_at)."""
        for bump_idx, ver in self.machine_versions:
            if bump_idx <= idx:
                return ver
        return 0

    def handle_machine_effect(self, eff: Any) -> list:
        """Called by the shell for machine effects that mutate log state
        (ra_server.erl:2018-2046).

        The snapshot/checkpoint meta must record the configuration in
        force AT eff.index, not the live view: cluster changes take
        effect on append, so the view can contain an in-flight change
        NEWER than the snapshot point — if that change is later
        reverted, a snapshot stamped with it would immortalize a
        configuration that never existed, and installs would spread it
        (found by the combined fuzz; the reference stamps the live
        cluster, ra_server.erl:2018-2027, and shares the hazard)."""
        cluster_spec = self._cluster_spec_at(eff.index)
        mac_ver = self._machine_version_at(eff.index)
        if isinstance(eff, ReleaseCursor):
            return self.log.update_release_cursor(
                eff.index, cluster_spec, mac_ver, eff.machine_state)
        if isinstance(eff, Checkpoint):
            return self.log.checkpoint(
                eff.index, cluster_spec, mac_ver, eff.machine_state)
        if isinstance(eff, PromoteCheckpoint):
            self.log.promote_checkpoint(eff.index)
            return []
        return []

    # -- introspection -----------------------------------------------------

    def overview(self) -> dict:
        return {
            "id": self.id,
            "raft_state": self.raft_state.value,
            "current_term": self.current_term,
            "voted_for": self.voted_for,
            "leader_id": self.leader_id,
            "commit_index": self.commit_index,
            "last_applied": self.last_applied,
            "query_index": self.query_index,
            "membership": self.membership.value,
            "cluster_change_permitted": self.cluster_change_permitted,
            "machine_version": self.machine_version,
            "effective_machine_version": self.effective_machine_version,
            "cluster": {pid: {"match_index": p.match_index,
                              "next_index": p.next_index,
                              "status": p.status.value,
                              "membership": p.membership.value}
                        for pid, p in self.cluster.items()},
            "log": self.log.overview(),
        }


# ---------------------------------------------------------------------------
# module helpers
# ---------------------------------------------------------------------------

def _log_up_to_date(idx: int, term: int, last: IdxTerm) -> bool:
    """§5.4.1 up-to-date check (ra_server.erl:2486-2493)."""
    if term > last.term:
        return True
    if term == last.term and idx >= last.index:
        return True
    return False


def dict_from_cluster_spec(spec: tuple) -> dict:
    return {sid: Peer(membership=m) for sid, m in spec}


def _follower_catchup_predicate(event: Any, server: "RaServer") -> bool:
    """Condition is met when a message arrives that lets the follower make
    progress again: an AER whose prev point we can evaluate, or a snapshot
    (follower_catchup_cond_fun)."""
    if isinstance(event, AppendEntriesRpc):
        if event.term < server.current_term:
            return False
        if event.prev_log_index == 0:
            return True
        last_idx = server.last_idx_term().index
        return event.prev_log_index <= last_idx
    if isinstance(event, InstallSnapshotRpc):
        return event.term >= server.current_term
    return False


def _transfer_leadership_predicate(event: Any, server: "RaServer") -> bool:
    """Old leader waits in await_condition until it sees a message from the
    new leader (an AER/vote in a higher term)."""
    return isinstance(event, (AppendEntriesRpc, RequestVoteRpc, PreVoteRpc,
                              HeartbeatRpc))


def _wal_up_predicate(event: Any, server: "RaServer") -> bool:
    """wal_down condition exits when the restarted WAL announces itself
    (ra_server.erl:538-554 — the {error, wal_down} hold).  Liveness is
    re-checked: a stale WalUpEvent from an incarnation that already died
    again must not unpark the server — the replay would hit WalDown on
    the first append and drop the rest of the postponed backlog."""
    return isinstance(event, WalUpEvent) and \
        getattr(server.log, "wal_is_up", lambda: True)()


_FOLLOWER_SAFE_EFFECTS = (ReleaseCursor, Checkpoint, AuxEffect,
                          GarbageCollection, SendMsg, LogReadEffect, Monitor,
                          Reply, SendRpc, StartElectionTimeout,
                          NextEvent, Notify)
# NB: TimerEffect is NOT follower-safe — machine timers are armed by the
# leader only (they are absent from the keep-list of
# filter_follower_effects, ra_server.erl:1817-1860); the shell
# additionally drops an expiry that races a leadership loss.


def _filter_follower_effects(effects: list) -> list:
    """Followers suppress most machine effects — they are emitted by the
    leader only (filter_follower_effects, ra_server.erl:1815-1860).
    release_cursor/checkpoint/aux/gc and local sends are kept."""
    out = []
    for e in effects:
        if isinstance(e, Monitor) and e.component == "machine":
            continue
        if isinstance(e, Notify):
            continue
        if isinstance(e, SendMsg) and "local" not in e.options:
            continue
        if isinstance(e, Reply) and isinstance(e.msg, CommandResult) and \
                e.replier == "leader":
            # leader-replier consensus replies: follower copies dropped
            # ({reply,_,_,leader} filtering); member-replier replies
            # survive — the named member executes them at the shell
            continue
        if isinstance(e, _FOLLOWER_SAFE_EFFECTS):
            out.append(e)
    return out
