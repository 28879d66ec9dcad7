"""Search algorithms of the port.

``TorchIncrementalGP`` and ``CudaIncrementalGP`` are not imported here, as
in the reference: ``gp_mode="torch"``/``"cuda"`` import them lazily.
"""
from repro_torch.core.search.base import SearchAlgorithm
from repro_torch.core.search.random_search import RandomSearch
from repro_torch.core.search.grid import GridSearch
from repro_torch.core.search.nsga2 import NSGA2
from repro_torch.core.search.bayesopt import (BayesOpt, GP, IncrementalGP, PAL,
                                              tune_lengthscale)
from repro_torch.core.search.driver import SearchDriver
from repro_torch.core.search.hypervolume import (hypervolume, hypervolume_2d,
                                                 hypervolume_3d)

ALGORITHMS = {
    "random": RandomSearch,
    "grid": GridSearch,
    "nsga2": NSGA2,
    "bayesopt": BayesOpt,
    "pal": PAL,
}
