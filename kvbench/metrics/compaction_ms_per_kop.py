"""compaction_ms_per_kop: host-clock time inside the engine's
maintenance loop (rate limit, watermark, read policy: every
``compact_once`` and ``select_range``) and the quantized drain
(``drain_tick``), each call ending in a synchronise, summed over the
traced part of the window, per thousand ops of its steps."""

WRAP = (("repro_torch.core.engine", "maintenance"),
        ("repro_torch.core.engine", "drain_tick"))
SYNC = True
NAME = "compaction_ms_per_kop"


def read(run):
    if not run.spans.calls.get(NAME) or not run.traced_ops:
        return None
    return 1e3 * run.spans.host_s[NAME] / (run.traced_ops / 1e3)
