"""Feature extractors: ContentVec content features and CREPE pitch."""

from ns2vc_tpu_torch.features.contentvec import (
    ContentVec,
    convert_fairseq_hubert,
    load_contentvec,
)

__all__ = ["ContentVec", "convert_fairseq_hubert", "load_contentvec"]
