"""Hardware constants the port's design space reads.

Only the ladders of ``hw`` are ported so far; the roofline model itself
(``HwModel``, ``analysis``, ``traffic``) comes with the explore loop.
"""
