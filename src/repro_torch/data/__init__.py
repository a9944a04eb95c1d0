from repro_torch.data.pipeline import SyntheticLMDataset, make_dataset

__all__ = ["SyntheticLMDataset", "make_dataset"]
