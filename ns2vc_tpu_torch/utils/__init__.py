"""Utilities of the port."""

from ns2vc_tpu_torch.utils.wavio import read_wav, write_wav

__all__ = ["read_wav", "write_wav"]
