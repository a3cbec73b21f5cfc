"""Python-file config system with ``_base_`` composition.

API-compatible reimplementation of the mmcv ``Config`` surface the reference
relies on (``configs/jy/prototype4.py:2-5`` uses ``_base_`` lists;
``tools/train.py:60-69`` uses ``--cfg-options`` deep merges;
``prototype4.py:97`` uses ``_delete_=True`` subtree replacement). Configs are
plain Python files executed in an isolated namespace; inheritance is a deep
dict merge, child over base.
"""

from __future__ import annotations

import ast
import copy
import os.path as osp
import types
from typing import Any, Dict

DELETE_KEY = '_delete_'
BASE_KEY = '_base_'


class ConfigDict(dict):
    """dict with attribute access (cfg.model.bbox_head.type)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        other = ConfigDict()
        memo[id(self)] = other
        for k, v in self.items():
            other[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return other


def _to_config_dict(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _merge_dict(base: dict, child: dict) -> dict:
    """Deep merge ``child`` into ``base`` (child wins); a child dict bearing
    ``_delete_=True`` replaces the base subtree wholesale."""
    out = dict(base)
    for key, val in child.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict) \
                and not val.pop(DELETE_KEY, False):
            out[key] = _merge_dict(out[key], val)
        else:
            if isinstance(val, dict):
                val = {k: v for k, v in val.items() if k != DELETE_KEY}
            out[key] = val
    return out


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(filename)
    with open(filename) as f:
        source = f.read()
    # Validate early for a good error message.
    ast.parse(source, filename=filename)
    mod = types.ModuleType('_cfg_')
    mod.__file__ = filename
    exec(compile(source, filename, 'exec'), mod.__dict__)
    return {k: v for k, v in mod.__dict__.items()
            if not k.startswith('__') and not isinstance(v, types.ModuleType)}


def _load_with_bases(filename: str) -> Dict[str, Any]:
    cfg_dict = _exec_pyfile(filename)
    bases = cfg_dict.pop(BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base in bases:
        base_path = osp.join(osp.dirname(osp.abspath(filename)), base)
        merged = _merge_dict(merged, _load_with_bases(base_path))
    return _merge_dict(merged, cfg_dict)


class Config:
    """mmcv-compatible Config facade."""

    def __init__(self, cfg_dict: dict = None, filename: str = None):
        object.__setattr__(self, '_cfg_dict',
                           _to_config_dict(cfg_dict or {}))
        object.__setattr__(self, '_filename', filename)

    @staticmethod
    def fromfile(filename: str) -> 'Config':
        return Config(_load_with_bases(filename), filename=filename)

    @property
    def filename(self):
        return self._filename

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = _to_config_dict(value)

    def __getitem__(self, key):
        return self._cfg_dict[key]

    def __setitem__(self, key, value):
        self._cfg_dict[key] = _to_config_dict(value)

    def __contains__(self, key):
        return key in self._cfg_dict

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def copy(self) -> 'Config':
        return Config(copy.deepcopy(dict(self._cfg_dict)), self._filename)

    def merge_from_dict(self, options: Dict[str, Any]):
        """``--cfg-options a.b.c=v`` style deep overrides
        (reference tools/train.py:60-69)."""
        nested: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = nested
            keys = full_key.split('.')
            for k in keys[:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = v
        merged = _merge_dict(dict(self._cfg_dict), nested)
        object.__setattr__(self, '_cfg_dict', _to_config_dict(merged))

    def dump(self) -> str:
        import pprint
        return pprint.pformat(dict(self._cfg_dict), width=100)
