"""Lightweight YAML config composer: the port's copy of ``matcha_tpu/utils/configs.py``.

A base YAML with nested groups, experiment overlays merged on top
(``experiment=v19``), dotted CLI overrides with YAML-typed values, and
``${a.b}`` interpolation resolved after merging.  PyYAML is imported only
when a file or an override is parsed, and a clear error says so when it is
missing: the trainer itself builds from dataclasses and needs no YAML.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any

_INTERP = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")


def _yaml():
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(
            "YAML configs need PyYAML; build MatchaConfig / OptimizerConfig / "
            "TrainerConfig in Python instead, or install pyyaml"
        ) from exc
    return yaml


def load_yaml(path: str | Path) -> dict:
    with open(path) as f:
        return _yaml().safe_load(f) or {}


def deep_merge(base: dict, overlay: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def get_dotted(cfg: dict, dotted: str) -> Any:
    node: Any = cfg
    for k in dotted.split("."):
        node = node[k]
    return node


def parse_override(token: str) -> tuple[str, Any]:
    """``a.b=value`` with YAML-typed parsing of the value.

    YAML 1.1 doesn't treat ``1e-4`` as a float (needs ``1.0e-4``), but it is
    the natural CLI spelling — coerce numeric-looking strings explicitly.
    """
    if "=" not in token:
        raise ValueError(f"Override {token!r} must look like key=value")
    key, raw = token.split("=", 1)
    value = _yaml().safe_load(raw)
    if isinstance(value, str):
        try:
            value = float(value)
        except ValueError:
            pass
    return key.strip(), value


def resolve_interpolations(cfg: dict) -> dict:
    """Replace ``${a.b}`` string values with the referenced node."""

    def resolve(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v) for v in node]
        if isinstance(node, str):
            m = _INTERP.match(node)
            if m:
                return resolve(get_dotted(cfg, m.group(1)))
        return node

    return resolve(cfg)


def compose(
    base_path: str | Path,
    overrides: list[str] | None = None,
    experiment_dir: str | Path | None = None,
) -> dict:
    """base YAML → optional experiment overlay → CLI overrides → interp."""
    cfg = load_yaml(base_path)
    overrides = list(overrides or [])

    exp_tokens = [o for o in overrides if o.startswith("experiment=")]
    overrides = [o for o in overrides if not o.startswith("experiment=")]
    for token in exp_tokens:
        name = token.split("=", 1)[1]
        exp_dir = Path(experiment_dir or Path(base_path).parent / "experiment")
        cfg = deep_merge(cfg, load_yaml(exp_dir / f"{name}.yaml"))

    for token in overrides:
        key, value = parse_override(token)
        set_dotted(cfg, key, value)

    return resolve_interpolations(cfg)
