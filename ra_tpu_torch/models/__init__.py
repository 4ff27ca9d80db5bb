from .counter import CounterMachine
from .fifo import FifoMachine
from .fifo_client import FifoClient, Mailbox, StopSending
from .jit_fifo import JitFifoMachine
from .jit_kv import JitKvMachine
from .kv import KvMachine
from .queue import QueueMachine
from .registers import RegisterMachine
from .stream import StreamMachine
from .ttl_kv import TtlKvMachine

__all__ = ["CounterMachine", "FifoClient", "FifoMachine", "JitFifoMachine",
           "JitKvMachine", "KvMachine", "Mailbox", "QueueMachine",
           "RegisterMachine", "StopSending", "StreamMachine", "TtlKvMachine"]
