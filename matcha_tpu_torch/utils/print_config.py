"""Config-tree pretty printing (reference: matcha/utils/rich_utils.py).

The port's own copy of ``matcha_tpu/utils/print_config.py`` (same flags, same output);
it imports nothing of the JAX package.

Prints the composed config as an indented tree at train start so runs are
self-documenting in the log; pure-stdlib (no rich dependency).
"""

from __future__ import annotations

from typing import Any


def format_tree(cfg: dict, indent: int = 0) -> str:
    lines = []
    pad = "  " * indent
    for key, value in cfg.items():
        if isinstance(value, dict):
            lines.append(f"{pad}{key}:")
            lines.append(format_tree(value, indent + 1))
        else:
            lines.append(f"{pad}{key}: {value!r}")
    return "\n".join(l for l in lines if l)


def print_config(cfg: dict, title: str = "config") -> None:
    bar = "─" * 60
    print(f"┌{bar}\n│ {title}\n├{bar}")
    for line in format_tree(cfg).splitlines():
        print(f"│ {line}")
    print(f"└{bar}")
