"""The paper's worked examples (Figs. 5, 8, 9) on the port's public
names: every assertion of ``tests/test_paper_examples.py``, with
``device="cpu"`` (the plain PyTorch versions)."""
import numpy as np
import pytest

from repro_torch.core import (Policy, Trace, demand_blocks, make_cache, pod,
                              simulate_single_level, simulate_two_level, trd,
                              urd)

CPU = "cpu"

# Fig. 8 workload: R S1, R S2, R S3, W S4, W S5, R S1, R S4
FIG8 = Trace.from_ops([('R', 1), ('R', 2), ('R', 3), ('W', 4), ('W', 5),
                       ('R', 1), ('R', 4)])
# Fig. 9 workload: W S1, R S2, R S3, W S4, W S5, R S3, R S1
FIG9 = Trace.from_ops([('W', 1), ('R', 2), ('R', 3), ('W', 4), ('W', 5),
                       ('R', 3), ('R', 1)])
# Fig. 5 workload: R S1, R S2, R S3, W S1, W S4, R S1, R S4
FIG5 = Trace.from_ops([('R', 1), ('R', 2), ('R', 3), ('W', 1), ('W', 4),
                       ('R', 1), ('R', 4)])


class TestFig8WBWO:
    def test_urd_is_4(self):
        assert urd(FIG8, CPU) == 4     # RAR S1: {S2,S3,S4,S5} in between

    def test_urd_allocates_5_blocks(self):
        assert demand_blocks(urd(FIG8, CPU)) == 5

    def test_pod_wbwo_is_1(self):
        assert pod(FIG8, Policy.WBWO, CPU) == 1  # RAW S4: {S5} in between

    def test_pod_wbwo_allocates_2_blocks(self):
        assert demand_blocks(pod(FIG8, Policy.WBWO, CPU)) == 2

    def test_trd_counts_every_reaccess(self):
        # RAW S4 after {S5}, RAR S1 after {S2..S5}: TRD == URD here
        assert trd(FIG8, CPU) == 4


class TestFig9RO:
    def test_urd_is_4(self):
        assert urd(FIG9, CPU) == 4

    def test_pod_ro_is_0(self):
        assert pod(FIG9, Policy.RO, CPU) == 0  # RAR S3, nothing read between

    def test_pod_ro_allocates_1_block(self):
        assert demand_blocks(pod(FIG9, Policy.RO, CPU)) == 1


class TestFig5TwoLevel:
    """One-level WB SSD: 5 SSD writes / 2 read hits; ETICA two-level:
    2 SSD writes with the same hit count (paper: '60% fewer')."""

    def test_one_level_wb(self):
        st = make_cache(1, 3, CPU)
        _, stats, _ = simulate_single_level(
            np.asarray(FIG5.addr), np.asarray(FIG5.is_write), st, 3,
            Policy.WB)
        assert int(stats.cache_writes_l2) == 5
        assert int(stats.read_hits_l2) == 2

    def test_two_level_etica(self):
        dram, ssd = make_cache(1, 3, CPU), make_cache(1, 3, CPU)
        _, _, stats, _ = simulate_two_level(
            np.asarray(FIG5.addr), np.asarray(FIG5.is_write), dram, ssd,
            3, 3, mode="npe")
        assert int(stats.cache_writes_l2) == 2
        assert int(stats.read_hits_l1) + int(stats.read_hits_l2) == 2

    def test_reduction_is_60_percent(self):
        assert 1 - 2 / 5 == pytest.approx(0.6)


class TestPolicySemantics:
    """Paper §3 policy table."""

    def test_alloc_predicates(self):
        assert Policy.WB.allocates_reads and Policy.WB.allocates_writes
        assert Policy.WT.allocates_reads and Policy.WT.allocates_writes
        assert Policy.RO.allocates_reads and not Policy.RO.allocates_writes
        assert not Policy.WBWO.allocates_reads
        assert Policy.WBWO.allocates_writes

    def test_reliability(self):
        # RO and WT never hold dirty data (reliability of write-pending)
        assert not Policy.RO.holds_dirty
        assert not Policy.WT.holds_dirty
        assert Policy.WB.holds_dirty

    def test_pod_wb_equals_urd(self):
        # paper key idea 4: in a WB cache URD and POD work similarly
        for tr in (FIG5, FIG8, FIG9):
            assert pod(tr, Policy.WB, CPU) == urd(tr, CPU)

