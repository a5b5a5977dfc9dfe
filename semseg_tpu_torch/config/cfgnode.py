"""Minimal yacs-compatible configuration node (``semseg_tpu/config/cfgnode.py``).

The port's own copy of the JAX package's module, so that the port imports
nothing of ``semseg_tpu``. The reference framework configures itself through
a yacs ``CfgNode`` singleton (``mit_semseg/config/defaults.py:1-97``) merged
from YAML files and CLI ``opts`` remainder lists (``train.py:235-236``). yacs
is not a dependency, so this module re-implements the subset the framework
needs, preserving yacs semantics:

* attribute-style access (``cfg.TRAIN.lr_encoder``)
* ``merge_from_file(path)`` — YAML overrides, type-checked against defaults
* ``merge_from_list([k, v, k, v, ...])`` — dotted-key CLI overrides
* yacs value decoding: YAML string values that parse as Python literals
  (e.g. ``"(300, 375, 450, 525, 600)"``) are converted via ``ast.literal_eval``
  so the reference's shipped config files load verbatim.
"""

from __future__ import annotations

import ast
import copy
import io

import yaml

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))


class CfgNode(dict):
    """A dict subclass with attribute access and yacs-style merging."""

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            self[k] = v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    # -- cloning / dumping -------------------------------------------------
    def clone(self):
        return copy.deepcopy(self)

    def dump(self, **kwargs):
        def convert(node):
            if isinstance(node, CfgNode):
                return {k: convert(v) for k, v in node.items()}
            return node

        stream = io.StringIO()
        yaml.safe_dump(convert(self), stream, default_flow_style=False, **kwargs)
        return stream.getvalue()

    def __str__(self):
        return self.dump()

    # -- merging -----------------------------------------------------------
    def merge_from_file(self, cfg_filename):
        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        _merge_a_into_b(CfgNode(loaded), self, self, [])

    def merge_from_other_cfg(self, cfg_other):
        _merge_a_into_b(cfg_other, self, self, [])

    def merge_from_list(self, cfg_list):
        assert len(cfg_list) % 2 == 0, (
            f"Override list has odd length: {cfg_list}"
        )
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            d = self
            key_parts = full_key.split(".")
            for sub_key in key_parts[:-1]:
                assert sub_key in d, f"Non-existent key: {full_key}"
                d = d[sub_key]
            sub_key = key_parts[-1]
            assert sub_key in d, f"Non-existent key: {full_key}"
            value = _decode_cfg_value(v)
            d[sub_key] = _check_and_coerce(value, d[sub_key], full_key)


def _decode_cfg_value(value):
    """Decode a raw config value following yacs rules.

    Strings are tentatively parsed as Python literals so YAML like
    ``imgSizes: (300, 375)`` (a string to YAML) becomes a tuple.
    """
    if isinstance(value, dict):
        return CfgNode(value)
    if not isinstance(value, str):
        return value
    try:
        value = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    return value


def _check_and_coerce(replacement, original, full_key):
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type == original_type or original is None:
        return replacement

    # yacs casts between these pairs
    casts = [(tuple, list), (list, tuple), (int, float), (float, int)]
    for src, dst in casts:
        if replacement_type == src and original_type == dst:
            return dst(replacement)

    raise ValueError(
        f"Type mismatch ({original_type} vs {replacement_type}) for key "
        f"{full_key}: {original!r} -> {replacement!r}"
    )


def _merge_a_into_b(a, b, root, key_list):
    for k, v_ in a.items():
        full_key = ".".join(key_list + [k])
        if k not in b:
            raise KeyError(f"Non-existent config key: {full_key}")
        v = _decode_cfg_value(v_)
        if isinstance(v, CfgNode) and isinstance(b[k], CfgNode):
            _merge_a_into_b(v, b[k], root, key_list + [k])
        else:
            b[k] = _check_and_coerce(v, b[k], full_key)
