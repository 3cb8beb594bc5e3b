"""Canned workloads: YCSB A-F, Twitter-cluster mixes, and beyond-paper
phased scenarios (the port's copy of the JAX package's
``workloads/specs.py``; paper §7 runs YCSB A-F and three Twitter
clusters, the scenarios exercise churn regimes the static mixes cannot).
"""
from __future__ import annotations

from repro_torch.workloads.schedule import PhaseSchedule, schedule
from repro_torch.workloads.spec import WorkloadSpec, spec

YCSB_KINDS = ("A", "B", "C", "D", "E", "F")


def ycsb(kind: str, theta: float = 0.99, scan_len: int = 16,
         hot_offset: int = 0) -> WorkloadSpec:
    """YCSB core workloads.  E is a REAL range scan (start key from the
    read distribution + bounded length driving the sorted-index scan
    path); D reads the latest distribution and inserts sequentially."""
    common = dict(theta=theta, hot_offset=hot_offset, scan_len=scan_len)
    if kind == "A":                      # update heavy 50/50
        return spec(read=0.5, **common)
    if kind == "B":                      # read mostly 95/5
        return spec(read=0.95, **common)
    if kind == "C":                      # read only
        return spec(read=1.0, **common)
    if kind == "D":                      # read latest 95/5, seq inserts
        return spec(read=0.95, dist="latest", **common)
    if kind == "E":                      # short ranges 95/5, seq inserts
        return spec(read=0.0, scan=0.95, wdist="seq", **common)
    if kind == "F":                      # read-modify-write 50/50
        return spec(read=0.5, **common)
    raise ValueError(kind)


TWITTER_CLUSTERS = ("cluster39", "cluster19", "cluster51")


def twitter(cluster: str, theta: float = 0.99) -> WorkloadSpec:
    """Three representative Twitter cache mixes (paper §7 / Yang et al.):
    write-heavy uniform, read-heavy skewed-read, read-dominant skewed."""
    if cluster == "cluster39":
        return spec(read=0.06, dist="uniform")
    if cluster == "cluster19":
        return spec(read=0.75, dist="zipf", theta=theta, wdist="uniform")
    if cluster == "cluster51":
        return spec(read=0.90, dist="zipf", theta=theta)
    raise ValueError(cluster)


SCENARIOS = ("hotset-shift", "diurnal", "flash-crowd", "scan-burst",
             "delete-churn")


def scenario(name: str, key_space: int, n_batches: int) -> PhaseSchedule:
    """Beyond-paper phased scenarios, ``n_batches`` split across phases.

    hotset-shift  the zipf hot set jumps to disjoint key regions -- does
                  pinning/promotion track the shift?
    diurnal       read/write mix swings day -> night -> day
    flash-crowd   uniform traffic, then a sudden extreme-skew crowd on
                  one region, then back to baseline
    scan-burst    point-op steady state interrupted by an analytics-style
                  range-scan burst (YCSB-E-like phase)
    delete-churn  insert-heavy growth alternating with delete-heavy
                  shrink: tombstones + compaction reclamation pressure
    """
    def split(*weights):
        ns = [max(int(n_batches * w), 1) for w in weights]
        ns[-1] = max(n_batches - sum(ns[:-1]), 1)
        return ns

    if name == "hotset-shift":
        ns = split(1 / 3, 1 / 3, 1 / 3)
        return schedule([
            (ycsb("B", hot_offset=off), n)
            for off, n in zip((0, key_space // 3, 2 * key_space // 3), ns)])
    if name == "diurnal":
        ns = split(0.25, 0.25, 0.25, 0.25)
        mixes = (0.95, 0.6, 0.25, 0.6)       # day -> evening -> night -> day
        return schedule([(spec(read=r), n) for r, n in zip(mixes, ns)])
    if name == "flash-crowd":
        ns = split(0.4, 0.2, 0.4)
        return schedule([
            (spec(read=0.8, dist="uniform"), ns[0]),
            (spec(read=0.95, theta=1.25, hot_offset=key_space // 7), ns[1]),
            (spec(read=0.8, dist="uniform"), ns[2])])
    if name == "scan-burst":
        ns = split(0.4, 0.2, 0.4)
        burst = spec(read=0.1, scan=0.8, scan_len=24)
        return schedule([(ycsb("B"), ns[0]), (burst, ns[1]),
                         (ycsb("B"), ns[2])])
    if name == "delete-churn":
        ns = split(0.3, 0.2, 0.3, 0.2)
        grow = spec(read=0.2, dist="uniform")
        shrink = spec(read=0.5, delete=0.5, put=0.0)
        return schedule([(grow, ns[0]), (shrink, ns[1]), (grow, ns[2]),
                         (shrink, ns[3])])
    raise ValueError(name)
