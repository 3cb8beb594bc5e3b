"""The system under test: ``repro_torch``'s ``PrismDB`` built from a
configuration file, and the few counters the benchmark reads from it.

``shrink`` (for a rehearsal on the CPU) divides every count of the
configuration by a factor and keeps its widths and fractions.
"""
from __future__ import annotations

import numpy as np

# counts of a configuration that scale with the deployment
COUNTS = ("key_space", "fast_slots", "slow_slots", "tracker_slots",
          "max_runs")
LOAD_BATCH_FLOOR = 512


def shrink(config: dict, factor: int) -> dict:
    """``config`` with its counts (and the load) cut by ``factor``; a
    load batch keeps at least LOAD_BATCH_FLOOR keys."""
    if factor <= 1:
        return config
    tier = dict(config["tier"])
    for k in COUNTS:
        tier[k] = max(tier[k] // factor, 64 if k == "max_runs" else 1)
    load = dict(config["load"])
    load["keys"] = max(load["keys"] // factor, 1)
    load["batch"] = max(load["batch"] // factor, LOAD_BATCH_FLOOR)
    return {**config, "tier": tier, "load": load}


class Store:
    """``PrismDB`` on ``device`` (None: the card) as ``config`` states,
    its own random draws (compaction candidates, pinning) from
    ``seed``."""

    def __init__(self, config: dict, seed: int, device=None):
        from repro_torch.core.db import PrismDB
        from repro_torch.core.tiers import TierConfig
        from repro_torch.core import engine
        self._engine = engine
        self.cfg = TierConfig(**config["tier"])
        eng = config["engine"]
        self.db = PrismDB(self.cfg, seed=seed,
                          backend=eng["backend"],
                          compaction_quantum=eng["compaction_quantum"],
                          promote=eng["promote"], precise=eng["precise"],
                          selection=eng["selection"],
                          pin_mode=eng["pin_mode"], device=device)
        self.key_space = self.cfg.key_space
        self.value_width = self.cfg.value_width
        self.high_watermark = self.cfg.high_watermark

    def put(self, keys, vals) -> None:
        self.db.put(keys, vals)

    def get(self, keys):
        vals, found, _ = self.db.get(keys)
        return vals, found

    def host_reads(self) -> int:
        """Device-to-host reads the engine's control flow has taken."""
        return self._engine.HOST_READS.n

    def compactions(self) -> int:
        return int(self.db.estate.tier.ctr.compactions)

    def occupancy(self) -> float:
        return float(np.float32(self.db.occupancy()))
