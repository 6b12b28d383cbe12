"""dCKKS: threshold (multiparty) CKKS protocols on PyTorch tensors."""

from lattigo_tpu_torch.models.dckks.protocols import (
    CKGProtocol,
    CKSProtocol,
    PCKSProtocol,
    RefreshProtocol,
    RKGProtocol,
    RKGProtocolNaive,
    RTGProtocol,
)

__all__ = [
    "CKGProtocol",
    "CKSProtocol",
    "PCKSProtocol",
    "RKGProtocol",
    "RKGProtocolNaive",
    "RTGProtocol",
    "RefreshProtocol",
]
