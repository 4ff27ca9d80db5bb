"""JitFifoMachine: a fixed-capacity FIFO queue a lane with the ra_fifo
command vocabulary (ordered enqueue, settled and unsettled dequeue,
settlement, return with redelivery count, purge, registered consumers
with credit, cancel and consumer-down requeue).  Counterpart of
``ra_tpu/models/jit_fifo.py``; equal to it on every state leaf and reply.

State (leading lane axis from ``jit_init``; the engine adds the member
axis): ``buf/dc/mid int32[Q]`` the ready ring (payload, delivery count,
enqueue ticket), ticket-sorted over ``head..tail-1`` (slot = idx mod Q);
``co_id/co_val/co_dc/co_mid/co_owner int32[K]`` the checked-out table
(``co_id < 0`` free; owner ``C`` = an anonymous op-3 checkout);
``con_pid/con_credit int32[C]`` consumers (pid < 0 free); ``head``,
``tail``, ``next_id``, ``next_mid``, ``n_dropped`` int32.  ``capacity``
bounds live messages (ready + checked out); ``overflow`` is ``"reject"``
(reply -2) or ``"drop_head"`` (drop the oldest ready message).

Command encoding (command_spec int32[3]): ``[op, a, b]``
  0 noop            1 enqueue(value)        2 dequeue settled
  3 dequeue unsettled (anon)   4 settle(id)  5 return(id)   6 purge
  7 attach(pid, credit)        8 cancel(pid) 9 down(pid)
  10 checkout(pid)             11 set_credit(pid, credit)
(replies as in the reference module).  A returned or requeued message
re-enters the ready window at its ticket rank with delivery count + 1.

On the CPU, as in the reference, a window of only
noop/enqueue/dequeue-settled commands folds in one vectorised pass
(:meth:`_batch_fast`) and any other window takes the in-order fold.  On a
card every window takes the in-order fold, the ``ops/csrc/fifo_fold.cu``
kernel, when the capacity is a power of two.  With any other capacity the
two folds place a clean window's entries differently where a lane's head
comes within about the capacity of the int32 edge (as the reference's
do), so there the card keeps the reference's choice: both folds run and
the fast one is kept where the window is clean.
"""
from __future__ import annotations

import torch

from ..core.machine import JitMachine, encode_i32
from ..ops.exact import add32, sum32
from ..ops.fifo_fold import MAX_CHECKOUT, MAX_SHARED_RING, \
    fifo_fold_dispatch, kernel_takes_capacity

I32 = torch.int32
#: the clamped-add scan's identity bounds (above any queue size)
_BIG = 1 << 20


def _take(arr, idx):
    return torch.gather(arr, -1, idx[..., None].long())[..., 0]


def _first(mask):
    """Index of the first True along the last axis (0 when none), as
    ``jnp.argmax`` over a bool."""
    return torch.argmax(mask.to(torch.uint8), dim=-1).to(I32)


def _mod(x, q: int):
    return torch.remainder(x, q)          # floor mod, as jnp.mod


def _scan_clamped_add(a, lo, hi):
    """Inclusive scan over the last axis of the clamped-add maps
    ``x -> clip(x + a, lo, hi)`` (element i applied after i-1), by
    doubling: log2(A) rounds.  The composition is exact in int32, so
    this gives ``lax.associative_scan``'s values whatever the order of
    association."""
    A, d = a.shape[-1], 1
    while d < A:
        a2, lo2, hi2 = a[..., d:], lo[..., d:], hi[..., d:]
        a = torch.cat([a[..., :d], a[..., :-d] + a2], dim=-1)
        lo, hi = (torch.cat([x[..., :d], torch.minimum(
            torch.maximum(x[..., :-d] + a2, lo2), hi2)], dim=-1)
            for x in (lo, hi))
        d *= 2
    return a, lo, hi


class JitFifoMachine(JitMachine):
    command_spec = ("int32", (3,))
    reply_spec = ("int32", ())
    version = 0
    supports_batch_apply = True

    def __init__(self, capacity: int = 64, checkout_slots: int = 8,
                 consumer_slots: int = 4,
                 overflow: str = "reject") -> None:
        if overflow not in ("reject", "drop_head"):
            raise ValueError(f"unknown overflow policy {overflow!r}")
        self.capacity = capacity
        #: a capacity that is no power of two: the card selects between
        #: the two folds as the CPU does
        self.fast_fold_on_card = bool(capacity & (capacity - 1))
        self.checkout_slots = checkout_slots
        self.consumer_slots = consumer_slots
        self.overflow = overflow

    def check_device(self, device: torch.device) -> None:
        """On a CUDA device: refuse the tables the fold kernel cannot fold
        (more than 32 checkout slots; a capacity longer than the ring
        shared memory holds that is not a power of two)."""
        if device.type != "cuda":
            return
        Q, K = self.capacity, self.checkout_slots
        if K > MAX_CHECKOUT or not kernel_takes_capacity(Q):
            raise ValueError(
                f"JitFifoMachine(capacity={Q}, checkout_slots={K}) does not "
                f"run on the card: its fold kernel takes up to "
                f"{MAX_CHECKOUT} checkout slots and a capacity up to "
                f"{MAX_SHARED_RING} or a power of two")

    def jit_init(self, n_lanes: int, device: torch.device):
        N, Q, K, C = (n_lanes, self.capacity, self.checkout_slots,
                      self.consumer_slots)

        def z(*s):
            return torch.zeros(s, dtype=I32, device=device)

        def neg(*s):
            return torch.full(s, -1, dtype=I32, device=device)

        return {"buf": z(N, Q), "dc": z(N, Q), "mid": z(N, Q),
                "head": z(N), "tail": z(N),
                "co_id": neg(N, K), "co_val": z(N, K), "co_dc": z(N, K),
                "co_mid": z(N, K), "co_owner": z(N, K),
                "con_pid": neg(N, C), "con_credit": z(N, C),
                "next_id": z(N), "next_mid": z(N), "n_dropped": z(N)}

    def jit_apply(self, meta, command, state):
        Q, C = self.capacity, self.consumer_slots
        dev = command.device
        op = command[..., 0]
        a = command[..., 1]
        b = command[..., 2]
        head, tail = state["head"], state["tail"]
        next_id, next_mid = state["next_id"], state["next_mid"]
        buf, dc, mid = state["buf"], state["dc"], state["mid"]
        co_id, co_val = state["co_id"], state["co_val"]
        co_dc, co_mid = state["co_dc"], state["co_mid"]
        co_owner = state["co_owner"]
        con_pid, con_credit = state["con_pid"], state["con_credit"]
        n_dropped = state["n_dropped"]

        size = tail - head
        empty = size <= 0
        checked = sum32((co_id >= 0).to(I32))
        full = (size + checked) >= Q          # capacity bounds LIVE msgs

        # -- consumer-table resolution (ops 7-11) -------------------------
        cr = torch.arange(C, device=dev)
        pid_match = (con_pid == a[..., None]) & (a[..., None] >= 0)
        pid_found = pid_match.any(dim=-1)
        pid_slot = _first(pid_match)
        con_free = con_pid < 0
        have_con_free = con_free.any(dim=-1)
        free_con_slot = _first(con_free)

        # -- enqueue -------------------------------------------------------
        enq_ok = (op == 1) & ~full
        if self.overflow == "drop_head":
            enq_drop = (op == 1) & full & (size > 0)
        else:
            enq_drop = torch.zeros_like(enq_ok)
        enq = enq_ok | enq_drop
        tail_slot = _mod(tail, Q)
        n_dropped = add32(n_dropped, enq_drop.to(I32))

        # -- dequeue (settled / unsettled / consumer checkout) ------------
        head_slot = _mod(head, Q)
        head_val = _take(buf, head_slot)
        head_dc = _take(dc, head_slot)
        head_mid = _take(mid, head_slot)
        free_mask = co_id < 0                              # [..., K]
        have_free = free_mask.any(dim=-1)
        free_slot = _first(free_mask)
        deq_s = (op == 2) & ~empty
        deq_u = (op == 3) & ~empty & have_free
        owned = (co_id >= 0) & (co_owner == pid_slot[..., None])
        used = sum32(owned.to(I32))
        credit = _take(con_credit, pid_slot)
        deq_c = ((op == 10) & pid_found & ~empty & have_free &
                 (used < credit))
        take = deq_u | deq_c
        pop = deq_s | take

        # -- settle / return: locate the checked-out row -------------------
        match = (co_id == a[..., None]) & (a[..., None] >= 0)
        found = match.any(dim=-1)
        match_slot = _first(match)
        settle = (op == 4) & found
        ret = (op == 5) & found

        purge = op == 6
        cancel = ((op == 8) | (op == 9)) & pid_found
        req_n = torch.where(cancel, used, 0)

        # -- cursor updates ------------------------------------------------
        head = add32(add32(head, pop.to(I32)), enq_drop.to(I32))
        head = torch.where(purge, tail, head)
        new_tail = add32(tail, enq.to(I32))

        # -- enqueue ring write -------------------------------------------
        # ring positions in int32 as the reference's: an offset from the
        # head wraps like XLA's int32 subtraction (it matters where Q is
        # not a power of two and the head sits at the int32 edge)
        qr = torch.arange(Q, device=dev, dtype=I32)
        enq_hot = (qr == tail_slot[..., None]) & enq[..., None]
        buf = torch.where(enq_hot, a[..., None], buf)
        dc = torch.where(enq_hot, 0, dc)
        mid = torch.where(enq_hot, next_mid[..., None], mid)
        new_next_mid = add32(next_mid, enq.to(I32))

        # -- the requeue merge (op-5 return and cancel/down): each requeued
        # row lands at its ticket rank in the merged window, and the ready
        # entries shift back by the requeued tickets below them.  Computed
        # always and kept in the rows that requeue.  (The reference keeps
        # it in every row of the batch once any row requeues, behind a
        # lax.cond; that is the same wherever the merge of a row with
        # nothing to requeue is the identity, which it is unless Q is not
        # a power of two and the head sits at the int32 edge: there its
        # wrapped offsets move a bystander's ready entries.)
        kr = torch.arange(self.checkout_slots, device=dev)
        req = (cancel[..., None] & owned) | \
            (ret[..., None] & (kr == match_slot[..., None]))
        n_req = sum32(req.to(I32))
        new_head = head - n_req

        size2 = new_tail - head
        in_win = _mod(add32(qr, -head[..., None].long()), Q) < \
            size2[..., None]
        rank = sum32((in_win[..., None, :] &
                      (mid[..., None, :] < co_mid[..., :, None])).to(I32))
        rank = rank + sum32((req[..., None, :] &
                             (co_mid[..., None, :] < co_mid[..., :, None]))
                            .to(I32))
        rank = torch.where(req, rank, -1)     # inactive rows never land
        jd = _mod(add32(qr, -new_head[..., None].long()), Q)   # [..., Q]
        valid = jd < (size2 + n_req)[..., None]
        eq = rank[..., :, None] == jd[..., None, :]            # [..., K, Q]
        land = eq.any(dim=-2)

        def at_rank(x):
            return sum32(torch.where(eq, x[..., :, None], 0), dim=-2)

        cnt_lt = sum32(((rank[..., :, None] >= 0) &
                        (rank[..., :, None] < jd[..., None, :])).to(I32),
                       dim=-2)
        src_slot = _mod(add32(add32(head[..., None], jd), -cnt_lt.long()),
                        Q).long()
        merged = tuple(
            torch.where(valid, torch.where(land, at_rank(r),
                                           torch.gather(x, -1, src_slot)), x)
            for x, r in ((buf, co_val), (dc, add32(co_dc, 1)),
                         (mid, co_mid)))
        requeues = (n_req > 0)[..., None]
        buf, dc, mid = (torch.where(requeues, m, x)
                        for m, x in zip(merged, (buf, dc, mid)))
        head = new_head

        # -- checkout-table writes ----------------------------------------
        take_hot = (kr == free_slot[..., None]) & take[..., None]
        rel_hot = (kr == match_slot[..., None]) & (settle | ret)[..., None]
        co_val = torch.where(take_hot, head_val[..., None], co_val)
        co_dc = torch.where(take_hot, head_dc[..., None], co_dc)
        co_mid = torch.where(take_hot, head_mid[..., None], co_mid)
        co_owner = torch.where(
            take_hot, torch.where(deq_c, pid_slot, C)[..., None], co_owner)
        co_id = torch.where(take_hot, next_id[..., None], co_id)
        co_id = torch.where(rel_hot | (cancel[..., None] & owned), -1, co_id)
        new_next_id = add32(next_id, take.to(I32))

        # -- consumer attach / credit / cancel ----------------------------
        attach_ok = (op == 7) & (pid_found | have_con_free)
        attach_slot = torch.where(pid_found, pid_slot, free_con_slot)
        attach_hot = (cr == attach_slot[..., None]) & attach_ok[..., None]
        setc = (op == 11) & pid_found
        setc_hot = (cr == pid_slot[..., None]) & setc[..., None]
        con_pid = torch.where(attach_hot, a[..., None], con_pid)
        con_credit = torch.where(attach_hot | setc_hot, b[..., None],
                                 con_credit)
        cancel_hot = (cr == pid_slot[..., None]) & cancel[..., None]
        con_pid = torch.where(cancel_hot, -1, con_pid)

        # -- reply ---------------------------------------------------------
        reply = torch.where(op == 1, torch.where(enq, 1, -2), 0)
        reply = torch.where(op == 2, torch.where(deq_s, head_val, -1), reply)
        reply = torch.where(op == 3,
                            torch.where(deq_u, next_id,
                                        torch.where(empty, -1, -3)), reply)
        reply = torch.where(op == 4, settle.to(I32), reply)
        reply = torch.where(op == 5, ret.to(I32), reply)
        reply = torch.where(op == 6, size, reply)
        reply = torch.where(op == 7, torch.where(attach_ok, 1, -4), reply)
        reply = torch.where((op == 8) | (op == 9), req_n, reply)
        reply = torch.where(
            op == 10,
            torch.where(deq_c, next_id,
                        torch.where(~pid_found, -4,
                                    torch.where(empty, -1,
                                                torch.where(used >= credit,
                                                            -5, -3)))),
            reply)
        reply = torch.where(op == 11, setc.to(I32), reply)

        new_state = {"buf": buf, "dc": dc, "mid": mid, "head": head,
                     "tail": new_tail, "co_id": co_id, "co_val": co_val,
                     "co_dc": co_dc, "co_mid": co_mid,
                     "co_owner": co_owner, "con_pid": con_pid,
                     "con_credit": con_credit, "next_id": new_next_id,
                     "next_mid": new_next_mid, "n_dropped": n_dropped}
        return new_state, reply.to(I32)

    # -- one-shot window fold (engine batch path) --------------------------

    def jit_apply_batch(self, meta, commands, mask, state):
        return self.window_fold_dispatch(meta, commands, mask, state)

    def _fast_ok(self, commands, mask):
        # fast only for noop/enqueue/dequeue-settled windows: one op > 2
        # anywhere in the batch sends it all to the in-order fold
        return ~torch.any(mask & (commands[..., 0] > 2))

    def in_order_fold(self, meta, commands, mask, state):
        return fifo_fold_dispatch(self, meta, commands, mask, state)

    def _batch_fast(self, commands, mask, state):
        """The noop/enqueue/dequeue-settled window in one pass: the ready
        size before each command from a scan of clamped-add maps, ring
        positions from cumulative sums of the admit and pop flags, and each
        written slot's payload gathered from the admitted enqueue that
        holds its rank (the reference places it with a [..., Q, A] one-hot
        matmul; finding the command by ``searchsorted`` on the running
        admit count is the same selection in O(Q + A) a row)."""
        Q = self.capacity
        dev = commands.device
        op = torch.where(mask, commands[..., 0], 0)            # [..., A]
        val = commands[..., 1]
        head, tail = state["head"], state["tail"]              # [...]
        checked = sum32((state["co_id"] >= 0).to(I32))
        qeff = Q - checked                                     # live room
        size0 = tail - head

        is_enq = op == 1
        is_deq = op == 2
        # enqueue tops out at qeff (reject and drop_head both pin the ready
        # size there), dequeue floors at 0, noop is the identity
        a_el = is_enq.to(I32) - is_deq.to(I32)
        lo_el = torch.zeros_like(a_el)
        hi_el = torch.where(is_enq, qeff[..., None], Q).to(I32)
        a_in, lo_in, hi_in = _scan_clamped_add(a_el, lo_el, hi_el)

        # exclusive prefix: command i sees the composition of 0..i-1
        def shift(x, ident):
            return torch.cat([torch.full_like(x[..., :1], ident),
                              x[..., :-1]], dim=-1)

        s = torch.minimum(torch.maximum(size0[..., None] + shift(a_in, 0),
                                        shift(lo_in, -_BIG)),
                          shift(hi_in, _BIG))                  # pre-cmd size

        at_cap = s >= qeff[..., None]
        if self.overflow == "drop_head":
            enq_adm = is_enq & (~at_cap | (s > 0))
            enq_drop = is_enq & at_cap & (s > 0)
        else:
            enq_adm = is_enq & ~at_cap
            enq_drop = torch.zeros_like(enq_adm)
        deq_ok = is_deq & (s > 0)
        head_adv = deq_ok.to(I32) + enq_drop.to(I32)

        adm_csum = torch.cumsum(enq_adm.to(I32), dim=-1, dtype=I32)
        n_enq = adm_csum[..., -1]

        # written slots are ring indexes tail..tail+n_enq-1: a slot's window
        # offset jd says everything positional.  Windows wider than the
        # queue alias slots mod Q; only the last aliasing enqueue survives,
        # rank_win = jd + Q * floor((n_enq - 1 - jd) / Q)
        qr = torch.arange(Q, device=dev, dtype=I32)
        jd = _mod(add32(qr, -tail[..., None].long()), Q)       # [..., Q]
        written = jd < n_enq[..., None]
        rank_win = jd + Q * torch.div(n_enq[..., None] - 1 - jd, Q,
                                      rounding_mode="floor")
        # the admitted enqueue of exclusive rank r is the first command
        # whose running admit count reaches r + 1
        src = torch.searchsorted(adm_csum, (rank_win + 1).to(I32))
        placed = torch.gather(val, -1, src.clamp(max=op.shape[-1] - 1))

        new_state = dict(state)
        new_state["buf"] = torch.where(written, placed, state["buf"])
        new_state["dc"] = torch.where(written, 0, state["dc"])
        new_state["mid"] = torch.where(
            written, add32(state["next_mid"][..., None], rank_win),
            state["mid"])
        new_state["head"] = add32(head, sum32(head_adv))
        new_state["tail"] = add32(tail, n_enq)
        new_state["next_mid"] = add32(state["next_mid"], n_enq)
        new_state["n_dropped"] = add32(state["n_dropped"],
                                       sum32(enq_drop.to(I32)))
        return new_state

    # -- host protocol -----------------------------------------------------

    _OPS = {"settle": 4, "return": 5, "cancel": 8, "down": 9,
            "checkout": 10}

    def encode_command(self, command):
        try:
            if isinstance(command, tuple) and command:
                kind = command[0]
                if kind == "enqueue" and len(command) == 2:
                    v = int(command[1])
                    if v >= 0:
                        return encode_i32([1, v, 0])
                elif kind == "dequeue" and len(command) == 2:
                    if command[1] == "settled":
                        return encode_i32([2, 0, 0])
                    if command[1] == "unsettled":
                        return encode_i32([3, 0, 0])
                elif kind in self._OPS and len(command) == 2:
                    return encode_i32([self._OPS[kind], int(command[1]), 0])
                elif kind == "purge":
                    return encode_i32([6, 0, 0])
                elif kind in ("attach", "credit") and len(command) == 3:
                    return encode_i32([7 if kind == "attach" else 11,
                                       int(command[1]), int(command[2])])
        except (TypeError, ValueError, OverflowError):
            pass
        return torch.zeros((3,), dtype=I32)

    def decode_reply(self, reply) -> int:
        return int(reply)


def query_depth(state) -> torch.Tensor:
    """Ready-message count, per lane (int32 tensor)."""
    return state["tail"] - state["head"]


def query_checked_out(state) -> torch.Tensor:
    return (state["co_id"] >= 0).sum(dim=-1, dtype=I32)


def query_consumers(state) -> torch.Tensor:
    return (state["con_pid"] >= 0).sum(dim=-1, dtype=I32)


def query_dropped(state) -> torch.Tensor:
    return state["n_dropped"]
