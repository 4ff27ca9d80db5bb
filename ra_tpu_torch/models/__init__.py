from .counter import CounterMachine

__all__ = ["CounterMachine"]
