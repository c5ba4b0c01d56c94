"""Training on one card: optimizer, train step, fault-tolerant loop,
checkpoints (ports of ``repro.train``)."""

from repro_torch.train import checkpoint, fault_tolerance, loop, optimizer, step

__all__ = ["checkpoint", "fault_tolerance", "loop", "optimizer", "step"]
