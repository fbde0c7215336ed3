"""The paper's own experiment configuration (ETICA §5.1): 12 VMs running
MSR-family workloads over a DRAM+SSD two-level cache."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class EticaPaperConfig:
    vms: tuple = ("hm_1", "proj_0", "stg_1", "usr_0", "ts_0", "wdev_0",
                  "web_3", "usr_0", "mds_0", "src2_0", "rsrch_0", "mds_1")
    requests_per_vm: int = 20_000
    resize_interval: int = 10_000
    promo_interval: int = 1_000
    dram_fraction: float = 1.0 / 3.0   # DRAM:SSD capacity split


CONFIG = EticaPaperConfig()
