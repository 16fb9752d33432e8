from .pipeline import SyntheticLMDataset, make_batches, pseudo_embeds  # noqa: F401
