"""Device-resident observability plane (see ``repro_torch.obs.state``):
the names the JAX package's ``repro.obs`` exports."""
from repro_torch.obs.cost import (CostModel, TierCost, boundary_io_us,
                                  compaction_io_us, drain_io_us, step_io_us)
from repro_torch.obs.export import (bucket_bounds, bucket_of_us_np,
                                    events_table, hist_delta,
                                    hist_sum_delta, quantile_from_hist,
                                    quantiles_from_hist, snapshot,
                                    timeline_table, to_records, write_jsonl)
from repro_torch.obs.profile import maybe_trace
from repro_torch.obs.state import (EV_COMMIT, EV_RESUME, EV_START,
                                   EVENT_KIND_NAMES, KIND_NAMES, N_KINDS,
                                   TICK, TRIG_POLICY, TRIG_RATE_LIMIT,
                                   TRIG_WATERMARK, TRIGGER_NAMES, ObsConfig,
                                   ObsState, bucket_of_us, counter_delta,
                                   init, record_compaction, record_drain,
                                   record_step)


def __getattr__(name: str):
    # the two-tier timeline row layout; it reads repro_torch.core.tiers,
    # which is resolved at first use
    if name == "TIMELINE_FIELDS":
        from repro_torch.obs.state import timeline_fields
        return timeline_fields()
    raise AttributeError(name)


__all__ = [
    "CostModel", "TierCost", "boundary_io_us", "compaction_io_us",
    "drain_io_us", "step_io_us",
    "bucket_bounds", "bucket_of_us_np", "events_table", "hist_delta",
    "hist_sum_delta", "quantile_from_hist", "quantiles_from_hist",
    "snapshot", "timeline_table", "to_records", "write_jsonl",
    "maybe_trace", "EV_COMMIT", "EV_RESUME", "EV_START",
    "EVENT_KIND_NAMES", "KIND_NAMES", "N_KINDS", "TICK",
    "TIMELINE_FIELDS", "TRIG_POLICY", "TRIG_RATE_LIMIT", "TRIG_WATERMARK",
    "TRIGGER_NAMES", "ObsConfig", "ObsState", "bucket_of_us",
    "counter_delta", "init", "record_compaction", "record_drain",
    "record_step",
]
