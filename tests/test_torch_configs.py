"""The port's config data and parameter counts equal the JAX package's.

The port's ``ArchConfig`` has fields the JAX package's lacks (``PORT_ONLY``:
the softmax scale, rotary on or off, and three stream multipliers that
granite-4.0-h sets); every registered architecture leaves them at their
neutral defaults, and every other field equals the JAX package's.
"""
import dataclasses

import pytest

import repro.configs as jconfigs
from repro.models import transformer as jtransformer
from repro.models.model import count_params_analytic as jcount
import repro_torch.configs as configs
from repro_torch.models import transformer
from repro_torch.models.model import count_params_analytic

NAMES = jconfigs.list_archs()
PORT_ONLY = {"attn_scale": 0.0, "rope": True, "embedding_multiplier": 1.0,
             "residual_multiplier": 1.0, "logits_scaling": 1.0}


def _shared_fields(cfg):
    """``asdict(cfg)`` without the port-only fields, which must sit at their defaults."""
    out = dataclasses.asdict(cfg)
    assert {k: out.pop(k) for k in PORT_ONLY} == PORT_ONLY
    return out


def test_registry_and_shapes_match():
    assert configs.list_archs() == NAMES
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert configs.PAPER_ARCHS == jconfigs.PAPER_ARCHS
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    assert dataclasses.asdict(configs.LayerSpec("attn_local", "moe")) == \
        dataclasses.asdict(jconfigs.LayerSpec("attn_local", "moe"))


@pytest.mark.parametrize("name", NAMES)
def test_arch_config_matches(name):
    cfg, jcfg = configs.get_arch(name), jconfigs.get_arch(name)
    assert set(PORT_ONLY) == ({f.name for f in dataclasses.fields(cfg)}
                              - {f.name for f in dataclasses.fields(jcfg)})
    assert _shared_fields(cfg) == dataclasses.asdict(jcfg)
    assert _shared_fields(configs.reduced(cfg)) == dataclasses.asdict(jconfigs.reduced(jcfg))
    assert cfg.softmax_scale == cfg.d_head ** -0.5
    for shape in configs.SHAPES:
        assert (configs.shape_applicable(cfg, configs.SHAPES[shape])
                == jconfigs.shape_applicable(jcfg, jconfigs.SHAPES[shape]))
    for c, j in ((cfg, jcfg), (configs.reduced(cfg), jconfigs.reduced(jcfg))):
        assert count_params_analytic(c) == jcount(j)
        assert count_params_analytic(c, active_only=True) == jcount(j, active_only=True)
        assert c.param_count() == count_params_analytic(c)
        assert c.active_param_count() == j.active_param_count()
        # the port's layer order is the reference's section order
        assert ([(n, [(s.mixer, s.ffn) for s in g], sc) for n, g, sc in transformer.sections(c)]
                == [(n, [(s.mixer, s.ffn) for s in g], sc)
                    for n, g, sc in jtransformer._sections(j)])
