"""Config-option documentation generator (port of
``flink_tpu/config/docgen.py``).

Analog of the reference's generated configuration reference
(``flink-annotations/.../docs/Documentation.java`` + the ``flink-docs``
module, which renders every ``ConfigOption`` into the docs): walks the
registered option classes in :mod:`flink_tpu_torch.config.options` and emits a
markdown table per group.

    python -m flink_tpu_torch.config.docgen > docs/configuration.md
"""

from __future__ import annotations

import inspect
from typing import List

from flink_tpu_torch.config import options as options_module
from flink_tpu_torch.config.config_option import ConfigOption


def collect_option_groups():
    groups = []
    for name, obj in vars(options_module).items():
        if not inspect.isclass(obj) or name.startswith("_"):
            continue
        opts = [(k, v) for k, v in vars(obj).items()
                if isinstance(v, ConfigOption)]
        if opts:
            groups.append((name, sorted(opts)))
    return sorted(groups)


def render_markdown() -> str:
    lines: List[str] = ["# Configuration reference", "",
                        "Generated from the option classes in "
                        "`flink_tpu_torch/config/options.py` — do not edit by hand.",
                        ""]
    for group, opts in collect_option_groups():
        lines.append(f"## {group}")
        lines.append("")
        lines.append("| key | default | type | description |")
        lines.append("|---|---|---|---|")
        for _attr, opt in opts:
            desc = (opt.description or "").replace("|", "\\|")
            typ = getattr(opt.type, "__name__", opt.type)
            lines.append(f"| `{opt.key}` | `{opt.default!r}` | "
                         f"{typ} | {desc} |")
        lines.append("")
    return "\n".join(lines)


if __name__ == "__main__":
    print(render_markdown())
