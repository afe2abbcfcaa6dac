"""The port's own config (viewformer_tpu_torch.config) against the JAX
package's: the same fields and defaults, and a config.json written by either
package loads in the other. Also the port's entry points, which put their
tensors on the card unless the caller asks for the CPU.

`to_port` is how the port's tests hand a JAX config to the port: the port's
config built from the same values."""
import dataclasses

import pytest
import torch

from viewformer_tpu import config as jconfig
from viewformer_tpu.utils import schedules as jschedules
from viewformer_tpu_torch import config as tconfig
from viewformer_tpu_torch.utils import schedules as tschedules


def to_port(config):
    """The port's config with the values of a JAX package config."""
    return tconfig.load_config(config.asdict())


def _type_name(t):
    return t.__name__ if isinstance(t, type) else str(t)


def _defaults(cls):
    return {f.name: (f.default_factory() if f.default_factory is not dataclasses.MISSING
                     else f.default) for f in dataclasses.fields(cls) if f.init}


@pytest.mark.parametrize('name', ['MIGTConfig', 'VQGANConfig'])
def test_fields_and_defaults_match_jax(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert [(f.name, _type_name(f.type)) for f in dataclasses.fields(tcls)] == \
        [(f.name, _type_name(f.type)) for f in dataclasses.fields(jcls)]
    jdefaults, tdefaults = _defaults(jcls), _defaults(tcls)
    assert {k: str(v) for k, v in tdefaults.items()} == {k: str(v) for k, v in jdefaults.items()}
    assert tcls().asdict() == jcls().asdict()
    assert sorted(tconfig.supported_config_dict()) == sorted(jconfig.supported_config_dict())


CONFIGS = {
    'migt': dict(n_layer=3, dropout=0.0, localization_weight='linear(0,2,100)',
                 augment_poses='simple'),
    'migt_warmup': dict(localization_weight='warmup(cosine(0,1,1000),10)',
                        use_dynamic_pose_loss=True),
    'vqgan': dict(ch=32, ch_mult=[1, 2], attn_resolutions=[8], n_embed=16),
}


@pytest.mark.parametrize('case', sorted(CONFIGS))
@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_config_json_loads_in_the_other(tmp_path, case, writer):
    name = 'VQGANConfig' if case == 'vqgan' else 'MIGTConfig'
    values = CONFIGS[case]
    jc, tc = getattr(jconfig, name)(**values), getattr(tconfig, name)(**values)
    if writer == 'jax':
        jconfig.save_config(jc, str(tmp_path))
        loaded = tconfig.load_config(str(tmp_path))
        assert type(loaded) is getattr(tconfig, name)
        assert loaded.asdict() == tc.asdict() == jc.asdict()
    else:
        tconfig.save_config(tc, str(tmp_path))
        loaded = jconfig.load_config(str(tmp_path))
        assert type(loaded) is getattr(jconfig, name)
        assert loaded.asdict() == jc.asdict() == tc.asdict()
    if name == 'MIGTConfig':
        for step in (0, 5, 50, 500, 5000):
            assert tc.localization_weight.with_total_steps(tc.total_steps)(step) == \
                pytest.approx(jc.localization_weight.with_total_steps(jc.total_steps)(step))


@pytest.mark.parametrize('text', ['1', '0', 'linear(0,1,120000)', 'cosine(1,0,50)',
                                  'warmup(cosine(0,1,120000),2000)'])
def test_schedule_matches_jax(text):
    port, ref = tschedules.Schedule.from_str(text), jschedules.Schedule.from_str(text)
    assert str(port) == str(ref) and port.is_zero() == ref.is_zero()
    for step in (0, 1, 999, 2000, 60000, 200000):
        assert port(step) == pytest.approx(ref(step), rel=1e-12)
    with pytest.raises(TypeError, match='int or a float'):
        port(torch.tensor(1.0))


@pytest.mark.parametrize('entry', ['from_config', 'init_transformer_state', 'init_cache'])
def test_entry_points_default_to_the_card(entry):
    """With no device given, an entry point puts its tensors on the card;
    where there is none it raises and does not fall back to the CPU. Whether
    there is a card is decided here, in the test."""
    from viewformer_tpu_torch.models import AutoModel
    from viewformer_tpu_torch.models.migt_incremental import init_cache
    from viewformer_tpu_torch.train.transformer import init_transformer_state

    config = tconfig.MIGTConfig(n_embeddings=16, n_head=2, d_model=32, n_layer=1,
                                token_image_size=2)
    calls = {
        'from_config': lambda **kw: AutoModel.from_config(config, **kw).wte.weight,
        'init_transformer_state': lambda **kw: init_transformer_state(
            config, dtype=torch.float32, **kw)[0].wte.weight,
        'init_cache': lambda **kw: init_cache(config, 1, 2, **kw).k,
    }
    assert calls[entry](device='cpu').device.type == 'cpu'
    if torch.cuda.is_available():
        assert calls[entry]().device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
            calls[entry]()
