"""Peer-to-peer halo exchange (counterpart of
``apex_tpu/contrib/peer_memory``)."""

from apex_tpu_torch.contrib.peer_memory.halo_exchange import (  # noqa: F401
    PeerHaloExchanger1d,
    halo_exchange_1d,
)
