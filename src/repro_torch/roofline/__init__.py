"""The roofline model of the port: the design space's hardware model, the
analytic HBM traffic and the ``Artifact`` that JMeasure reads."""
from repro_torch.roofline.hw import HwModel, PEAK_FLOPS_BF16, HBM_BW, ICI_BW_PER_LINK
from repro_torch.roofline.analysis import Artifact, roofline_report
