"""Config system: python-file configs with mmdet-compatible key names.

Loads the same `configs/*.py` files as the JAX package: each file is
executed as a module and its top-level names become a recursive
attribute dict.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Any


class ConfigDict(dict):
    """dict with attribute access (recursive)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return ConfigDict(
                {k: ConfigDict.wrap(v) for k, v in obj.items()}
            )
        if isinstance(obj, (list, tuple)):
            return type(obj)(ConfigDict.wrap(v) for v in obj)
        return obj

    def get(self, key, default=None):
        return super().get(key, default)


class Config:
    """Loads a python config file into an attribute dict."""

    @staticmethod
    def fromfile(filename: str) -> ConfigDict:
        filename = os.path.abspath(os.path.expanduser(filename))
        spec = importlib.util.spec_from_file_location("_cfg", filename)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cfg = {
            k: v
            for k, v in vars(mod).items()
            if not k.startswith("__") and not callable(v)
            and not isinstance(v, type(os))
        }
        out = ConfigDict.wrap(cfg)
        out["_filename"] = filename
        with open(filename) as f:
            out["text"] = f.read()
        return out
