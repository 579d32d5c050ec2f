"""Roofline terms of a step on the H100 (port of ``repro.roofline``): the
reference's arithmetic, with the HLO parser's uses mapped onto the mesh's
counted collectives and one counted call (``analysis.py``)."""

from .analysis import (
    HW,
    CollectiveStats,
    RooflineReport,
    alpha_beta_disagreement,
    analyze_step,
    collective_stats_from_mesh,
    decode_bandwidth_bound_s,
    prefill_sharing_savings,
)

__all__ = [
    "HW",
    "CollectiveStats",
    "RooflineReport",
    "alpha_beta_disagreement",
    "analyze_step",
    "collective_stats_from_mesh",
    "decode_bandwidth_bound_s",
    "prefill_sharing_savings",
]
