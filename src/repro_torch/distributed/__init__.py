"""Distributed-execution pieces of the port; this slice has the
straggler model the service simulates arrivals with."""

from repro_torch.distributed.straggler import StragglerModel

__all__ = ["StragglerModel"]
