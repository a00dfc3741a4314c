"""The synthetic training-data pipeline."""

from .pipeline import DataConfig, SyntheticPipeline, make_batch_specs

__all__ = ["DataConfig", "SyntheticPipeline", "make_batch_specs"]
