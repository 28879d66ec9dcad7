"""JExplore core of the port: JHost orchestrates search over N JClients,
JConfig manages the knob space, JMeasure measures, results stream to CSV;
durable sweeps, fault injection, the fleet artifact store and the
multi-tenant service sit around that loop.
"""
from repro_torch.core.space import DesignSpace, Knob, tpu_pod_space, KIND_HW, KIND_SW
from repro_torch.core.jconfig import JConfig, TestConfig
from repro_torch.core.jmeasure import JMeasure, JTime, JPower, JMemory, DEFAULT_MEASURES
from repro_torch.core.fleet import FleetArtifactStore
from repro_torch.core.durable import (ExplorationCheckpoint, restore_sweep,
                                      tenant_checkpoint_dir)
from repro_torch.core.chaos import ChaosTransport
from repro_torch.core.jclient import JClient
from repro_torch.core.jhost import JHost
from repro_torch.core.results import ResultRecord, ResultStore, nondominated_mask
from repro_torch.core.scheduler import (Chunk, ClientSlot, DispatchScheduler,
                                        TenantState)
from repro_torch.core.tenancy import ExploreService
from repro_torch.core import codec, transport
from repro_torch.core.search import (
    ALGORITHMS, SearchAlgorithm, SearchDriver, RandomSearch, GridSearch,
    NSGA2, BayesOpt, GP, IncrementalGP, PAL, hypervolume,
)
