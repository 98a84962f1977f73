"""The synthetic LM data pipeline (port of ``repro.data``)."""
from repro_torch.data.pipeline import SyntheticLMDataset

__all__ = ["SyntheticLMDataset"]
