"""The paper's OWN system configuration (§VII-A Emulab setup) — deployment
descriptors for the storage service itself, selectable like an arch config.

    from repro_torch.configs.paper_store import EMULAB, AWS, make_dss

``make_dss`` passes any further ``DSSParams`` field through (``device``,
``coding_backend``, ``indexed``, ...).
"""
from dataclasses import dataclass

from repro_torch.core.store import DSS, DSSParams
from repro_torch.net.sim import LatencyModel


@dataclass(frozen=True)
class StoreConfig:
    name: str
    n_servers: int
    parity_m: int
    algorithm: str = "coaresecf"
    min_block: int = 1 << 17          # paper: min 512 kB (1:4 scale)
    avg_block: int = 1 << 17
    max_block: int = 1 << 18          # paper: max 1 MB
    base_lo: float = 0.1e-3           # Emulab LAN
    base_hi: float = 0.3e-3
    bandwidth: float = 125e6          # 1 Gbit/s


# §VII-D Emulab: 11 servers, m=5 (k=6) / m=1 (k=10); 5 writers, 5 readers
EMULAB = StoreConfig("emulab", n_servers=11, parity_m=5)
EMULAB_M1 = StoreConfig("emulab_m1", n_servers=11, parity_m=1)
# §VII-D AWS: 6 servers, m=4 (k=2) / m=1 (k=5); WAN-ish latencies
AWS = StoreConfig("aws", n_servers=6, parity_m=4, base_lo=5e-3, base_hi=25e-3)


def make_dss(cfg: StoreConfig, seed: int = 0, **params) -> DSS:
    fields = dict(
        algorithm=cfg.algorithm, n_servers=cfg.n_servers, parity_m=cfg.parity_m,
        seed=seed, min_block=cfg.min_block, avg_block=cfg.avg_block,
        max_block=cfg.max_block,
        latency=LatencyModel(base_lo=cfg.base_lo, base_hi=cfg.base_hi,
                             bandwidth=cfg.bandwidth),
    )
    fields.update(params)
    return DSS(DSSParams(**fields))
