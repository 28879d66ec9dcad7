"""Search algorithms of the port: the model-based searchers and their GPs.

``TorchIncrementalGP`` and ``CudaIncrementalGP`` are not imported here, as
in the reference: ``gp_mode="torch"``/``"cuda"`` import them lazily.
``RandomSearch``, ``GridSearch``, ``NSGA2``, ``SearchDriver`` and
``ALGORITHMS`` come with the explore loop.
"""
from repro_torch.core.search.base import SearchAlgorithm
from repro_torch.core.search.bayesopt import (BayesOpt, GP, IncrementalGP, PAL,
                                              tune_lengthscale)
from repro_torch.core.search.hypervolume import (hypervolume, hypervolume_2d,
                                                 hypervolume_3d)
