"""JExplore core of the port: the design space and the search algorithms.

JHost, JClient, the scheduler, JConfig and JMeasure come with the explore
loop (ROADMAP); this package holds what the searchers need.
"""
from repro_torch.core.space import DesignSpace, Knob, tpu_pod_space, KIND_HW, KIND_SW
from repro_torch.core.results import nondominated_mask
from repro_torch.core.search import (SearchAlgorithm, BayesOpt, GP, IncrementalGP,
                                     PAL, hypervolume)
