"""Roofline analysis of the port's dry run: analytic model FLOPs, the
per-device terms of a step counted as it runs on meta DTensors, and the
reference's HLO parser (the twin of ``repro/roofline``)."""
from repro_torch.roofline.analysis import (
    HW,
    ProgramCost,
    RooflineReport,
    analyze_program,
    collective_bytes_from_hlo,
)

__all__ = ["HW", "ProgramCost", "RooflineReport", "analyze_program",
           "collective_bytes_from_hlo"]
