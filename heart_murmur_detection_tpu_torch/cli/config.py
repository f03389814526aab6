"""Minimal hydra-compatible config system.

A copy of heart_murmur_detection_tpu/cli/config.py without its jax-only
helper; it reads the same configs/<name>.yaml. tests/test_torch_extract.py
pins it to the original.

The reference uses hydra YAML configs with `key=value` CLI overrides and `-m`
multirun sweeps over comma-separated values (scripts/lp_eval.sh:36-40). This
re-implements that surface without the hydra dependency: configs live in
configs/<name>.yaml, overrides are `key=value` args, `-m` produces the
cartesian product of comma-separated override values.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Dict, Iterator, List

import yaml

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "configs")


def _coerce(value: str) -> Any:
    if value in ("None", "null"):
        return None
    if value in ("True", "true"):
        return True
    if value in ("False", "false"):
        return False
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value


def _coerce_tree(v):
    # yaml 1.1 reads `1e-5` as a string (mantissa-less exponent); hydra's
    # OmegaConf reads it as a float — match hydra so checkpoint filename
    # prefixes (str(l2_strength) etc.) agree between train and re-eval.
    if isinstance(v, str):
        return _coerce(v)
    if isinstance(v, list):
        return [_coerce_tree(x) for x in v]
    if isinstance(v, dict):
        return {k: _coerce_tree(x) for k, x in v.items()}
    return v


def load_config(name: str) -> Dict[str, Any]:
    path = os.path.join(CONFIG_DIR, name + ".yaml")
    with open(path) as f:
        return {k: _coerce_tree(v) for k, v in (yaml.safe_load(f) or {}).items()}


def parse_overrides(argv: List[str]):
    """Returns (multirun, [{k: v}, ...]) — a list of override dicts (one per
    sweep combination when -m is given)."""
    multirun = False
    pairs = []
    for a in argv:
        if a in ("-m", "--multirun"):
            multirun = True
            continue
        if "=" not in a:
            raise SystemExit(f"override must be key=value, got: {a}")
        k, v = a.split("=", 1)
        pairs.append((k, v))

    if not multirun:
        return False, [{k: _coerce(v) for k, v in pairs}]

    keys = [k for k, _ in pairs]
    value_lists = [[_coerce(x) for x in v.split(",")] for _, v in pairs]
    combos = [dict(zip(keys, c)) for c in itertools.product(*value_lists)]
    return True, combos


def resolve(name: str, argv: List[str]) -> Iterator[Dict]:
    """Load config `name` and yield one merged dict per run (multirun-aware)."""
    base = load_config(name)
    _, combos = parse_overrides(argv)
    for c in combos:
        cfg = dict(base)
        cfg.update(c)
        # yaml parses a bare `None` as the string "None"; normalize (the
        # reference also string-compares 'None', circor_processing.py:303-308)
        yield {k: (None if v == "None" else v) for k, v in cfg.items()}
