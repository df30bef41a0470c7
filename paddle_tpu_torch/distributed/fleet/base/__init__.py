from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, get_hcg,
)
