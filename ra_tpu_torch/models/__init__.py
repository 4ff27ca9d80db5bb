from .counter import CounterMachine
from .jit_fifo import JitFifoMachine
from .jit_kv import JitKvMachine
from .registers import RegisterMachine
from .stream import StreamMachine
from .ttl_kv import TtlKvMachine

__all__ = ["CounterMachine", "JitFifoMachine", "JitKvMachine",
           "RegisterMachine", "StreamMachine", "TtlKvMachine"]
