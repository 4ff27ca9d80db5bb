"""Machine registry — named, picklable machine specifications.

The reference starts servers on REMOTE nodes by shipping a config whose
machine is a module name + args (plain atoms/terms over rpc:call,
ra_server_sup_sup.erl:42-130) and recovers the same config from the
target's disk on restart.  ra_tpu_torch machines are Python objects, so the
cross-node equivalent is a **spec**: ``("$machine", name, kwargs)``
resolved against a process-local registry on the node that actually
constructs the server.  Specs are picklable, travel over the TCP
control plane, and persist in the directory's config snapshot so a
remote restart can rebuild the machine from disk alone
(recover_config, ra_server_sup_sup.erl:80-103).

Register custom machines at import time on every node process::

    from ra_tpu_torch.machines import register_machine
    register_machine("my_queue", lambda **kw: MyQueueMachine(**kw))

Built-in models are pre-registered: fifo, jit_fifo, jit_kv, registers,
counter (an integer-adding SimpleMachine).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

_REGISTRY: dict = {}

SPEC_TAG = "$machine"


def register_machine(name: str, factory: Callable[..., Any]) -> None:
    """Register ``factory(**kwargs) -> Machine`` under ``name``."""
    _REGISTRY[name] = factory


def machine_spec(name: str, **kwargs: Any) -> tuple:
    """A picklable machine description for cross-node start/restart."""
    return (SPEC_TAG, name, kwargs)


def is_machine_spec(obj: Any) -> bool:
    return (isinstance(obj, tuple) and len(obj) == 3 and
            obj[0] == SPEC_TAG and isinstance(obj[1], str) and
            isinstance(obj[2], dict))


def resolve_machine(spec: Any):
    """Build the machine named by ``spec`` (idempotent on Machine
    instances so local callers can pass either).  The resolved machine
    remembers its spec (``_machine_spec``) so config snapshots persist
    it for disk-based recovery."""
    from .core.machine import Machine

    if isinstance(spec, Machine):
        return spec
    if not is_machine_spec(spec):
        raise ValueError(f"not a machine spec: {spec!r}")
    _tag, name, kwargs = spec
    factory = _REGISTRY.get(name)
    if factory is None:
        raise KeyError(f"machine {name!r} is not registered on this node "
                       f"(known: {sorted(_REGISTRY)})")
    machine = factory(**kwargs)
    machine._machine_spec = (SPEC_TAG, name, dict(kwargs))
    return machine


def spec_of(machine: Any) -> Optional[tuple]:
    """The spec a machine was resolved from, if any — what the config
    snapshot persists for remote/disk recovery."""
    return getattr(machine, "_machine_spec", None)


def _register_builtins() -> None:
    def counter(initial: int = 0):
        from .core.machine import SimpleMachine
        return SimpleMachine(lambda c, s: s + c, initial)

    def fifo(**kw):
        from .models import FifoMachine
        return FifoMachine(**kw)

    def jit_fifo(**kw):
        from .models import JitFifoMachine
        return JitFifoMachine(**kw)

    def jit_kv(**kw):
        from .models import JitKvMachine
        return JitKvMachine(**kw)

    def registers(**kw):
        from .models import RegisterMachine
        return RegisterMachine(**kw)

    register_machine("counter", counter)
    register_machine("fifo", fifo)
    register_machine("jit_fifo", jit_fifo)
    register_machine("jit_kv", jit_kv)
    register_machine("registers", registers)


_register_builtins()
