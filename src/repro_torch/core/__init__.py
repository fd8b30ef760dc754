"""The paper's contribution: CoARES, CoARESF, EC-DAP/EC-DAPopt (+ checkers),
plus the beyond-paper self-healing repair subsystem (``repro_torch.core.repair``)
and the Session/future client API (``repro_torch.core.api``)."""
from repro_torch.core.api import OpStats, Session, Workload, gather
from repro_torch.core.coares import CoAresClient, StaticCoverableClient
from repro_torch.core.gateway import Gateway, GossipListener
from repro_torch.core.fragment import (
    FragmentationModule,
    decode_block_value,
    encode_block_value,
    encode_genesis_meta,
    genesis_id,
    parse_genesis_meta,
)
from repro_torch.core.repair import ObjectHealth, RepairController, RepairDaemon, probe_health
from repro_torch.core.server import StorageServer
from repro_torch.core.store import ALGORITHMS, DSS, ClientHandle, DSSParams
from repro_torch.core.tags import TAG0, Config, CSeqEntry, OpRecord, Tag, next_tag
from repro_torch.core.workload import CrashStorm, WorkloadGen, WorkloadSpec
from repro_torch.net.sim import (
    DeadlineExceeded,
    FaultEvent,
    FaultPlan,
    QuorumUnavailableError,
    RetryPolicy,
    RpcTimeout,
)

__all__ = [
    "Session",
    "WorkloadGen",
    "WorkloadSpec",
    "CrashStorm",
    "Gateway",
    "GossipListener",
    "Workload",
    "OpStats",
    "gather",
    "CoAresClient",
    "StaticCoverableClient",
    "ObjectHealth",
    "probe_health",
    "FragmentationModule",
    "RepairController",
    "RepairDaemon",
    "StorageServer",
    "DSS",
    "DSSParams",
    "ClientHandle",
    "ALGORITHMS",
    "Config",
    "CSeqEntry",
    "OpRecord",
    "Tag",
    "TAG0",
    "next_tag",
    "genesis_id",
    "encode_block_value",
    "decode_block_value",
    "encode_genesis_meta",
    "parse_genesis_meta",
    "RetryPolicy",
    "FaultPlan",
    "FaultEvent",
    "QuorumUnavailableError",
    "RpcTimeout",
    "DeadlineExceeded",
]
