"""A bounded stream gate in CUDA: holds a stream until the host opens it
or a time limit passes, so that the executor's event pairs time the
device and not the host."""
from .ops import StreamGate, launches, load, reset_launches

__all__ = ["StreamGate", "launches", "reset_launches", "load"]
