"""Hierarchical YAML configuration with ``!include``, deep-merge overrides and
ablation grid generation.

A copy of ``loner_tpu/config/settings.py`` (which imports no JAX), so that
the port imports nothing of the JAX package: attribute-style ``Settings``,
``!include`` across files, ``augment`` deep-merges of leaf overrides, a
``baseline`` + ``changes`` file shape, and ``generate_options`` giving
cartesian or one-at-a-time ablation grids with descriptions.
"""
from __future__ import annotations

import copy
import itertools
import os
import pickle
from typing import Any, Iterable, List, Optional, Tuple

import yaml


class Settings(dict):
    """A dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d: Optional[dict] = None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = self._wrap(v)

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Settings):
            return Settings(v)
        if isinstance(v, list):
            return [Settings._wrap(x) for x in v]
        return v

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value):
        self[name] = self._wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __deepcopy__(self, memo):
        return Settings({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, Settings):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, Settings) else x for x in v]
            else:
                out[k] = v
        return out

    def augment(self, changes: Optional[dict]) -> "Settings":
        """Deep-merge leaf overrides into a copy (reference ``augment``,
        ``src/common/settings.py:66-75``)."""
        out = copy.deepcopy(self)
        if changes:
            _deep_merge(out, changes)
        return out

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value):
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Settings()
            node = node[part]
        node[parts[-1]] = value

    def dump_yaml(self, path: str):
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, default_flow_style=False)

    def dump_pickle(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self.to_dict(), f)

    @staticmethod
    def load_pickle(path: str) -> "Settings":
        with open(path, "rb") as f:
            return Settings(pickle.load(f))


def _deep_merge(base: dict, overrides: dict):
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_merge(base[k], v)
        else:
            base[k] = Settings._wrap(v)


class _IncludeLoader(yaml.SafeLoader):
    """YAML loader supporting ``!include relative/path.yaml``."""

    def __init__(self, stream):
        self._root = os.path.dirname(getattr(stream, "name", "."))
        super().__init__(stream)


def _include(loader: _IncludeLoader, node):
    rel = loader.construct_scalar(node)
    path = os.path.normpath(os.path.join(loader._root, rel))
    with open(path) as f:
        return yaml.load(f, _IncludeLoader)


_IncludeLoader.add_constructor("!include", _include)


def load_settings(path: str, overrides: Optional[dict] = None) -> Settings:
    """Load a YAML config (with !include). A top-level ``baseline`` key pointing
    at another YAML plus a ``changes`` dict (the reference's per-sequence file
    shape) is resolved recursively."""
    with open(path) as f:
        raw = yaml.load(f, _IncludeLoader)

    if isinstance(raw, dict) and "baseline" in raw:
        base_path = os.path.normpath(os.path.join(os.path.dirname(path), raw["baseline"]))
        settings = load_settings(base_path)
        settings = settings.augment(raw.get("changes", {}))
        for k, v in raw.items():
            if k not in ("baseline", "changes"):
                settings[k] = v
    else:
        settings = Settings(raw)

    if overrides:
        settings = settings.augment(overrides)
    return settings


def generate_options(
    baseline: Settings,
    overrides: dict,
    run_all_combos: bool = False,
) -> List[Tuple[Settings, str]]:
    """Ablation grids (reference ``generate_options``,
    ``src/common/settings.py:77-196``).

    ``overrides`` maps dotted paths to lists of values. ``run_all_combos``
    gives the cartesian product; otherwise one-at-a-time deviations from the
    baseline. Returns [(settings, description)].
    """
    items = sorted(overrides.items())
    results: List[Tuple[Settings, str]] = []

    if run_all_combos:
        keys = [k for k, _ in items]
        value_lists = [v if isinstance(v, list) else [v] for _, v in items]
        for combo in itertools.product(*value_lists):
            s = copy.deepcopy(baseline)
            desc_parts = []
            for k, v in zip(keys, combo):
                s.set_path(k, v)
                desc_parts.append(f"{k.split('.')[-1]}={v}")
            results.append((s, ",".join(desc_parts)))
    else:
        results.append((copy.deepcopy(baseline), "baseline"))
        for k, values in items:
            values = values if isinstance(values, list) else [values]
            for v in values:
                if baseline.get_path(k) == v:
                    continue
                s = copy.deepcopy(baseline)
                s.set_path(k, v)
                results.append((s, f"{k.split('.')[-1]}={v}"))
    return results


def generate_options_spec(
    baseline: Settings, spec: dict, run_all_combos: bool = False
) -> List[Tuple[Settings, str]]:
    """Ablation spec from a file: either a flat {dotted.path: [values]} dict
    (passed straight to ``generate_options``) or the grouped form of
    ``cfg/ablation_study.yaml`` (the reference's list-of-study-blocks,
    ``cfg/ablation_study.yaml``):

        groups:
          - run_all_combos: true      # cartesian within the group
            overrides: {path: [v..]}
          - overrides: {path: [v..]}  # one-at-a-time within the group

    The baseline run appears exactly once (from the first group)."""
    if not (isinstance(spec, dict) and "groups" in spec):
        return generate_options(baseline, spec, run_all_combos)
    results: List[Tuple[Settings, str]] = [(copy.deepcopy(baseline), "baseline")]
    for gi, group in enumerate(spec["groups"]):
        opts = generate_options(
            baseline,
            group.get("overrides", {}),
            group.get("run_all_combos", run_all_combos),
        )
        for s, desc in opts:
            if desc == "baseline":
                continue
            results.append((s, f"g{gi}:{desc}"))
    return results
