"""The paper's own configuration: PrismDB as a tiered KV store (the port's
own copy of the JAX package's ``configs/prismdb_kv.py``).

§7 of the paper scaled to simulation: 1:9 fast:total capacity, tracker =
10% of key space, pinning threshold 0.7, power-of-8 range selection.
``scale=1536`` is the paper's 100.7 M-key dataset.
"""
from repro_torch.core.tiers import TierConfig


def paper_tier_config(scale: int = 1) -> TierConfig:
    """scale=1 ~ 64k keys; the paper's 100M-key setup is scale 1536."""
    ks = (1 << 16) * scale
    return TierConfig(
        key_space=ks,
        fast_slots=ks // 9,        # ~11% on fast tier (paper's het10)
        slow_slots=ks,
        value_width=4,
        value_bytes=1024,          # 1 KB objects (paper §7)
        max_runs=max(ks // 2048, 64),
        run_size=2048,
        bloom_bits_per_run=1 << 15,
        tracker_slots=ks // 10,    # 10% of key space (paper §7)
        n_buckets=256,
        pin_threshold=0.7,         # paper §7
        power_k=8,                 # paper §A.1
    )
