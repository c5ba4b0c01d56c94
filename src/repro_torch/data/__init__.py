"""Synthetic packed training data (a copy of ``repro.data``)."""

from repro_torch.data.pipeline import DataConfig, SyntheticPacked, make_batch_iterator

__all__ = ["DataConfig", "SyntheticPacked", "make_batch_iterator"]
