"""Loader registry with uniform construction kwargs (port of
viewformer_tpu/data/loaders/__init__.py). Every loader takes shuffle,
shuffle_sequences, shuffle_sequence_items, sequence_size, image_size and
seed, through the wrappers of _wrappers.py unless the loader opts out with a
_custom_* class attribute.

Ported: colors and dataset. The JAX package's interiornet, sevenscenes,
shapenet, sm7, co3d and co3dv2 loaders are not ported yet; asking for them
raises.
"""
import importlib

from ._wrappers import ChangedImageSizeLoader, FixedSequenceSizeLoader, ShuffledLoader

_registry = {}
_lazy_modules = {
    'colors': ('viewformer_tpu_torch.data.loaders.colors', 'ColorsLoader'),
    'dataset': ('viewformer_tpu_torch.data.loaders.dataset', 'DatasetLoader'),
}
_NOT_PORTED = ('co3d', 'co3dv2', 'interiornet', 'sevenscenes', 'shapenet', 'sm7')


def _wrap_loader(loader_class):
    custom_resize = getattr(loader_class, '_custom_resize', False)
    custom_shuffle = getattr(loader_class, '_custom_shuffle', False)
    custom_sequence_size = getattr(loader_class, '_custom_sequence_size', False)

    def construct(shuffle_sequences=None, shuffle_sequence_items=None, shuffle=None,
                  sequence_size=None, image_size=None, seed=None, **kwargs):
        seed_val = seed if seed is not None else 42
        if seed is not None and not custom_shuffle:  # a custom shuffle takes seed_val below
            kwargs['seed'] = seed
        if custom_resize:
            kwargs['image_size'] = image_size
        if custom_sequence_size:
            kwargs['sequence_size'] = sequence_size
        if shuffle is not None:
            if shuffle_sequence_items is not None or shuffle_sequences is not None:
                raise ValueError('shuffle sets both shuffle_sequences and '
                                 'shuffle_sequence_items; pass one or the other')
            shuffle_sequence_items = shuffle_sequences = shuffle
        else:
            shuffle_sequence_items = shuffle_sequence_items or False
            shuffle_sequences = shuffle_sequences or False

        if custom_shuffle:
            loader = loader_class(shuffle_sequences=shuffle_sequences,
                                  shuffle_sequence_items=shuffle_sequence_items,
                                  sequence_size=sequence_size, seed=seed_val, **kwargs)
        else:
            loader = loader_class(**kwargs)
            if shuffle_sequence_items:
                loader = ShuffledLoader(loader, seed_val, shuffle_sequence_items=True)
            if sequence_size is not None and not custom_sequence_size:
                loader = FixedSequenceSizeLoader(loader, sequence_size)
            if shuffle_sequences:
                loader = ShuffledLoader(loader, seed_val, shuffle_sequences=True)
        if image_size is not None and not custom_resize:
            loader = ChangedImageSizeLoader(loader, image_size)
        return loader

    construct.loader_class = loader_class
    return construct


def register_loader(loader_class, name=None):
    if name is None:
        name = loader_class.__name__.lower()
        if name.endswith('loader'):
            name = name[:-len('loader')]
    _registry[name] = _wrap_loader(loader_class)
    return loader_class


def get_loader(name):
    if name not in _registry and name in _lazy_modules:
        module_name, class_name = _lazy_modules[name]
        register_loader(getattr(importlib.import_module(module_name), class_name), name)
    if name in _NOT_PORTED and name not in _registry:
        raise NotImplementedError(f'The {name!r} loader is not ported to viewformer_tpu_torch '
                                  f'yet; ported: {sorted(set(_registry) | set(_lazy_modules))}')
    if name not in _registry:
        raise ValueError(f'Unknown loader {name!r}; available: {get_loader_names()}')
    return _registry[name]


def build(name, *args, **kwargs):
    return get_loader(name)(*args, **kwargs)


def get_loader_names():
    return sorted(set(_registry) | set(_lazy_modules))
