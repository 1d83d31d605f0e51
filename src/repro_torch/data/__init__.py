from repro_torch.data.pipeline import (
    SyntheticAudioSource,
    SyntheticLMSource,
    make_source,
)

__all__ = ["SyntheticAudioSource", "SyntheticLMSource", "make_source"]
