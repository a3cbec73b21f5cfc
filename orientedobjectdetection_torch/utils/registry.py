"""Registry + recursive builder.

The reference is config-driven: every component is named by a registry string
(``type='RotatedRetinaNet'``) and built recursively
(``mmrotate/models/builder.py:6-56``, ``core/bbox/builder.py:1-22``). We keep
that public API surface — configs in ``configs/*`` must load unchanged — with
a single lightweight registry implementation instead of mmcv's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Registry:
    """Maps type-name strings to classes/callables, with recursive build."""

    def __init__(self, name: str, parent: Optional['Registry'] = None):
        self.name = name
        self._module_dict: Dict[str, Any] = {}
        self.parent = parent

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict or (
            self.parent is not None and key in self.parent)

    def __repr__(self):
        return f'Registry({self.name}, {sorted(self._module_dict)})'

    def _all_keys(self):
        keys = set(self._module_dict)
        if self.parent is not None:
            keys |= self.parent._all_keys()
        return keys

    def get(self, key: str):
        if key in self._module_dict:
            return self._module_dict[key]
        if self.parent is not None and key in self.parent:
            return self.parent.get(key)
        raise KeyError(f'{key!r} is not registered in {self.name} '
                       f'(known: {sorted(self._all_keys())})')

    def register_module(self, name: Optional[str] = None, module=None,
                        force: bool = False):
        """Use as decorator ``@REG.register_module()`` or direct call."""
        def _register(mod):
            key = name or mod.__name__
            if not force and key in self._module_dict:
                raise KeyError(f'{key} already registered in {self.name}')
            self._module_dict[key] = mod
            return mod

        if module is not None:
            return _register(module)
        return _register

    def build(self, cfg: dict, **default_args):
        """Instantiate from ``dict(type='Name', **kwargs)``.

        Nested dicts with a ``type`` key are NOT auto-built — components
        decide which children to build (mirrors mmcv behavior where builders
        are called explicitly).
        """
        if cfg is None:
            return None
        if not isinstance(cfg, dict) or 'type' not in cfg:
            raise TypeError(f'cfg must be a dict with a "type" key, got {cfg}')
        args = dict(cfg)
        obj_type = args.pop('type')
        for k, v in default_args.items():
            args.setdefault(k, v)
        if isinstance(obj_type, str):
            obj_cls = self.get(obj_type)
        else:
            obj_cls = obj_type
        try:
            return obj_cls(**args)
        except TypeError as e:
            raise TypeError(f'building {obj_type}: {e}') from e


# The registries the ported modules use (the reference's surface:
# models/builder.py:6-12, core/bbox/builder.py, core/anchor/builder.py).
MODELS = Registry('models')
BACKBONES = Registry('backbones', parent=MODELS)
NECKS = Registry('necks', parent=MODELS)
HEADS = Registry('heads', parent=MODELS)
DETECTORS = Registry('detectors', parent=MODELS)

LOSSES = Registry('losses', parent=MODELS)

BBOX_CODERS = Registry('bbox_coders')
DATASETS = Registry('datasets')
PIPELINES = Registry('pipelines')
BBOX_ASSIGNERS = Registry('bbox_assigners')
PRIOR_GENERATORS = Registry('prior_generators')


def build_from_cfg(cfg, registry: Registry, default_args: dict = None):
    return registry.build(cfg, **(default_args or {}))
