from repro_torch.data.pipeline import PrefetchPipeline, SyntheticLM  # noqa: F401
