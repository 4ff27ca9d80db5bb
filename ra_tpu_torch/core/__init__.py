from .machine import ApplyMeta, JitMachine, Machine, SimpleMachine
from .server import Peer, RaServer
from .types import *  # noqa: F401,F403 — types is the vocabulary module
