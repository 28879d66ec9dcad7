"""JExplore core of the port: JHost orchestrates search over N JClients,
JConfig manages the knob space, JMeasure measures, results stream to CSV.

The reference's durable sweeps, chaos transport, fleet store and tenancy
(``repro/core/{durable,chaos,fleet,tenancy}.py``) come with ROADMAP slice 6.
"""
from repro_torch.core.space import DesignSpace, Knob, tpu_pod_space, KIND_HW, KIND_SW
from repro_torch.core.jconfig import JConfig, TestConfig
from repro_torch.core.jmeasure import JMeasure, JTime, JPower, JMemory, DEFAULT_MEASURES
from repro_torch.core.jclient import JClient
from repro_torch.core.jhost import JHost
from repro_torch.core.results import ResultRecord, ResultStore, nondominated_mask
from repro_torch.core.scheduler import Chunk, ClientSlot, DispatchScheduler
from repro_torch.core import codec, transport
from repro_torch.core.search import (
    ALGORITHMS, SearchAlgorithm, SearchDriver, RandomSearch, GridSearch,
    NSGA2, BayesOpt, GP, IncrementalGP, PAL, hypervolume,
)
