from repro_torch.models.model import BuildFlags, Model, count_params_analytic
