"""The hardware-ladder knob values of the design space.

Copied from ``repro/roofline/hw.py``: the ladders that ``core.space`` turns
into the ``clock_scale``, ``hbm_scale`` and ``ici_scale`` knobs.
  clock_scale — compute-clock ladder (11 steps, 0.5 … 1.0)
  hbm_scale   — memory-clock ladder (4 steps; the lowest is 1/16)
  ici_scale   — interconnect ladder
"""
from __future__ import annotations

CLOCK_LADDER = tuple(round(0.5 + 0.05 * i, 2) for i in range(11))  # 0.5 … 1.0
HBM_LADDER = (1.0 / 16.0, 1.0 / 3.0, 2.0 / 3.0, 1.0)               # EMC analogue
ICI_LADDER = (0.25, 0.5, 0.75, 1.0)
