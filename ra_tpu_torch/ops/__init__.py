"""Quorum arithmetic: plain torch ops (``quorum``) and the hand-written
CUDA commit-quorum kernel (``pallas_quorum``, sources in ``csrc/``)."""
