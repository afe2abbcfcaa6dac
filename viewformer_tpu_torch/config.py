"""Model configuration dataclasses and registry (the port's own copy of
viewformer_tpu/config.py).

The same fields and defaults as the JAX package's, serialized to the same
`config.json` schema, so a config written by either package loads in the
other. The port imports nothing of the JAX package, so it keeps this copy.
"""
import copy
import json
import os
from dataclasses import dataclass, field, fields, is_dataclass
from typing import List

from .utils.schedules import Schedule


def asdict(obj):
    """Recursive dataclass -> dict that serializes Schedule fields to their
    DSL strings (viewformer_tpu/config.py:asdict)."""
    def _inner(obj):
        if isinstance(obj, Schedule):
            return str(obj)
        if is_dataclass(obj) and not isinstance(obj, type):
            return {f.name: _inner(getattr(obj, f.name)) for f in fields(obj)}
        if isinstance(obj, (list, tuple)):
            return type(obj)(_inner(v) for v in obj)
        if isinstance(obj, dict):
            return {_inner(k): _inner(v) for k, v in obj.items()}
        return copy.deepcopy(obj)
    return _inner(obj)


@dataclass
class ModelConfig:
    model: str = field(init=False)

    def __post_init__(self):
        cls_name = type(self).__name__
        assert cls_name.endswith('Config')
        self.model = cls_name[:-len('Config')].lower()

    def asdict(self):
        return asdict(self)

    @classmethod
    def supported_config_dict(cls):
        configs = {}
        if cls is not ModelConfig:
            configs[cls.__name__.lower()[:-len('config')]] = cls
        for c in cls.__subclasses__():
            configs.update(c.supported_config_dict())
        return configs

    @classmethod
    def from_dict(cls, data):
        data = dict(data)
        data.pop('model', None)
        kwargs = {}
        for f in fields(cls):
            if not f.init or f.name not in data:
                continue
            value = data[f.name]
            if f.type is Schedule or f.type == 'Schedule' or isinstance(f.default, Schedule):
                value = Schedule.from_str(value) if isinstance(value, str) else value
            kwargs[f.name] = value
        return cls(**kwargs)


def supported_config_dict():
    return ModelConfig.supported_config_dict()


def load_config(path_or_dict):
    """Load a ModelConfig from a config.json path, directory, or dict."""
    if isinstance(path_or_dict, dict):
        data = path_or_dict
    else:
        path = path_or_dict
        if os.path.isdir(path):
            path = os.path.join(path, 'config.json')
        with open(path) as f:
            data = json.load(f)
    model = data['model']
    configs = supported_config_dict()
    if model not in configs:
        raise ValueError(f'Unknown model type: {model!r}; supported: {sorted(configs)}')
    return configs[model].from_dict(data)


def save_config(config, directory):
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, 'config.json'), 'w') as f:
        json.dump(config.asdict(), f, indent=2, sort_keys=True)


@dataclass
class MIGTConfig(ModelConfig):
    """Masked-Image-Generation Transformer config."""
    n_embeddings: int = 1024
    n_head: int = 12
    d_model: int = 768
    dropout: float = 0.1
    n_layer: int = 12
    weight_decay: float = 0.01
    label_smoothing: float = 0.0
    learning_rate: float = 6.4e-4
    batch_size: int = 64
    gradient_clip_val: float = 0.0
    sequence_size: int = 20
    token_image_size: int = 8
    total_steps: int = 300000
    n_loss_skip: int = 4
    augment_poses: str = 'relative'  # no|relative|simple|advanced
    use_dynamic_pose_loss: bool = False
    localization_weight: Schedule = field(default_factory=lambda: Schedule.from_str('1'))
    image_generation_weight: float = 1.0
    pose_multiplier: float = 1.0
    random_pose_multiplier: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        if isinstance(self.localization_weight, (str, int, float)):
            self.localization_weight = Schedule.from_str(str(self.localization_weight))

    @property
    def model_type(self):
        return 'transformer'


@dataclass
class VQGANConfig(ModelConfig):
    """VQ-GAN codebook config."""
    learning_rate: float = 1.584e-3
    embed_dim: int = 256
    n_embed: int = 1024
    z_channels: int = 256
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    num_res_blocks: int = 2
    ch_mult: List[int] = field(default_factory=lambda: [1, 1, 2, 2, 4])
    attn_resolutions: List[int] = field(default_factory=lambda: [16])
    gradient_clip_val: float = 0.0
    batch_size: int = 352
    image_size: int = 128
    total_steps: int = 200000

    codebook_weight: float = 1.0
    pixelloss_weight: float = 1.0
    perceptual_weight: float = 1.0

    @property
    def stride(self):
        return 2 ** (len(self.ch_mult) - 1)

    @property
    def model_type(self):
        return 'codebook'
