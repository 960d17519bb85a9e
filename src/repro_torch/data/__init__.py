from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus

__all__ = ["DataPipeline", "SyntheticCorpus"]
