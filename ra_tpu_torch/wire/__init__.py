"""The wire plane: real sockets — and their in-process loopback twin —
into the ingress coalescer.  Counterpart of ``ra_tpu/wire/``: host
numpy and sockets over the port's ingress plane and engine.

* :mod:`~ra_tpu_torch.wire.framing` — the byte protocol: version byte,
  fixed-stride DATA records, CREDIT/ACK frames, ONE verdict enum +
  encoder shared with the fifo client's ``StopSending`` ladder.
* :class:`~ra_tpu_torch.wire.server.WireListener` — zero-per-command reader
  + the RA09-gated vectorized sweep feeding ``IngressPlane.submit``.
* :class:`~ra_tpu_torch.wire.client.WireClient` /
  :class:`~ra_tpu_torch.wire.client.LoopbackFleet` — the at-least-once
  client library (pipelined seqnos, credit-driven replay, epoch-bump
  re-enqueue).
* :class:`~ra_tpu_torch.wire.dedup.DedupCounterMachine` — machine-level
  dedup upgrading at-most-once to exactly-once-observable.
* :mod:`~ra_tpu_torch.wire.soak` — one rung of the loopback
  connection-ladder soak (``run_wire_soak``; ``chip_smoke.py``'s
  ``wire_path`` runs the 100,000-connection rung on the card).
"""
from .client import LoopbackFleet, WireClient
from .dedup import DedupCounterMachine
from .framing import (DEFER, DUP, OK, REJECT, SHED, SLOW, STATUS_NAMES,
                      WIRE_VERSION)
from .server import WireListener

__all__ = [
    "WireListener", "WireClient", "LoopbackFleet",
    "DedupCounterMachine", "WIRE_VERSION",
    "OK", "SLOW", "DEFER", "REJECT", "DUP", "SHED", "STATUS_NAMES",
]
