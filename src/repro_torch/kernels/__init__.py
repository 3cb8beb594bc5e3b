"""Hand-written Hopper kernels of the port and their launch counts.

Each kernel family lives in ``csrc/<name>.cu`` (CUDA C++ for ``sm_90a``,
built with ``nvcc`` into a shared library at first use, see
``kernels.build``) and is wrapped in ``kernels/<name>/ops.py``;
``tier_compact`` holds three kernels, each with its own count;
``flash_attention`` (B7), ``paged_attention`` (B6), ``rwkv6_scan``
(B8) and ``mamba_scan`` (B9) one each.  A wrapper adds one to
``LAUNCHES[name]`` each time it launches its kernel, and nowhere else,
so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

LAUNCHES = {"clock_update": 0, "msc_score": 0, "select_gather_rows": 0,
            "scatter_rows": 0, "gather_rows": 0, "flash_attention": 0,
            "paged_attention": 0, "rwkv6_scan": 0, "mamba_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
