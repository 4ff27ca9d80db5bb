from .machine import JitMachine

__all__ = ["JitMachine"]
