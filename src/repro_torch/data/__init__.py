from .pipeline import SyntheticLMDataset, make_batches  # noqa: F401
