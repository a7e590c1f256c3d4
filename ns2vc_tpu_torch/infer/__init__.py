"""Serving API of the port."""

from ns2vc_tpu_torch.infer.serve import MicroBatcher
from ns2vc_tpu_torch.infer.svc import RealTimeVC, Svc

__all__ = ["Svc", "RealTimeVC", "MicroBatcher"]
