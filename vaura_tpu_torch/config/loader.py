"""Layered-YAML configuration engine.

Counterpart of ``vaura_tpu/config/loader.py``: layered YAML files,
``${from_file:...}`` sub-config composition, ``${negation:...}``,
cross-section interpolation (``${dataloader.batch_size}``), CLI dotlist
merges, and mandatory-value markers (``???``). YAML is read by the port's
own reader of the configs' subset (``config/yaml_subset.py``), which gives
the objects PyYAML's ``safe_load`` gives and raises outside that subset.

The public API is :func:`load_config` / :func:`assemble_config` plus the
generic helpers :func:`deep_merge` and :func:`set_by_dotted`.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

from vaura_tpu_torch.config.yaml_subset import YamlSubsetError, load_file, safe_load

MANDATORY = "???"

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")
# YAML 1.1 parses "1e-6" (no dot) as a string; treat such scientific
# notation as the float the user obviously meant (OmegaConf does the same).
_SCI_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _numericize(value: Any) -> Any:
    if isinstance(value, str) and _SCI_FLOAT_RE.match(value.strip()):
        return float(value)
    return value


class MissingMandatoryValue(ValueError):
    pass


class ConfigError(ValueError):
    pass


def load_yaml(path: str | Path) -> dict:
    data = load_file(path)
    return data if data is not None else {}


def deep_merge(base: Any, override: Any) -> Any:
    """Merge ``override`` onto ``base`` recursively (dicts merge, other types
    replace). Returns a new structure; inputs are not mutated."""
    if isinstance(base, Mapping) and isinstance(override, Mapping):
        out = dict(copy.deepcopy(base))
        for k, v in override.items():
            if k in out:
                out[k] = deep_merge(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
        return out
    return copy.deepcopy(override)


def set_by_dotted(cfg: dict, dotted: str, value: Any) -> None:
    """Set ``cfg['a']['b']['c'] = value`` for dotted key ``"a.b.c"``,
    creating intermediate dicts as needed."""
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        nxt = node.get(k)
        if not isinstance(nxt, dict):
            nxt = {}
            node[k] = nxt
        node = nxt
    node[keys[-1]] = value


def get_by_dotted(cfg: Mapping, dotted: str, default: Any = None) -> Any:
    node: Any = cfg
    for k in dotted.split("."):
        if isinstance(node, Mapping) and k in node:
            node = node[k]
        elif isinstance(node, (list, tuple)):
            try:
                node = node[int(k)]
            except (ValueError, IndexError):
                return default
        else:
            return default
    return node


def parse_cli_value(raw: str) -> Any:
    """Parse a CLI value string with YAML semantics (``true`` -> bool, ...)."""
    try:
        return safe_load(raw)
    except YamlSubsetError:
        return raw


def parse_dotlist(argv: Sequence[str]) -> dict:
    """Parse ``key.subkey=value`` CLI arguments into a nested dict."""
    out: dict = {}
    for arg in argv:
        if "=" not in arg:
            raise ConfigError(f"CLI argument {arg!r} is not of the form key=value")
        key, _, raw = arg.partition("=")
        set_by_dotted(out, key.strip(), parse_cli_value(raw))
    return out


class _Resolver:
    """Resolves ``${...}`` expressions against a root config.

    Supported expressions:
      - ``${a.b.c}``            — interpolation from the config root
      - ``${from_file:path}``   — load & resolve another YAML file in place
      - ``${negation:expr}``    — boolean negation of the resolved expr
    """

    def __init__(self, root: dict, base_dir: Path):
        self.root = root
        self.base_dir = base_dir
        self._stack: list[str] = []

    def resolve(self, node: Any) -> Any:
        if isinstance(node, dict):
            return {k: self.resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [self.resolve(v) for v in node]
        if isinstance(node, str):
            return _numericize(self._resolve_str(node))
        return node

    @staticmethod
    def _find_interp(s: str):
        """Locate the first outermost ``${...}`` with brace matching;
        returns (start, end_exclusive) or None."""
        start = s.find("${")
        if start == -1:
            return None
        depth = 0
        i = start
        while i < len(s):
            if s.startswith("${", i):
                depth += 1
                i += 2
                continue
            if s[i] == "}":
                depth -= 1
                i += 1
                if depth == 0:
                    return start, i
                continue
            i += 1
        raise ConfigError(f"Unbalanced interpolation braces in {s!r}")

    def _resolve_str(self, s: str) -> Any:
        span = self._find_interp(s)
        if span is None:
            return s
        start, end = span
        expr = s[start + 2 : end - 1]
        value = self._eval(expr)
        if start == 0 and end == len(s) and s.strip() == s:
            return value
        return self._resolve_str(s[:start] + str(value) + s[end:])

    def _eval(self, expr: str) -> Any:
        expr = expr.strip()
        if expr in self._stack:
            raise ConfigError(f"Interpolation cycle at {expr!r}")
        self._stack.append(expr)
        try:
            if expr.startswith("from_file:"):
                rel = self._resolve_str(expr[len("from_file:") :].strip())
                rel = str(rel)
                path = (
                    Path(rel) if Path(rel).is_absolute() else (self.base_dir / rel)
                )
                sub_cfg = load_yaml(path)
                return self.resolve(sub_cfg)
            if expr.startswith("negation:"):
                inner = self._resolve_str(expr[len("negation:") :].strip())
                if isinstance(inner, str):
                    inner = safe_load(inner)
                return not bool(inner)
            # plain config path; resolve any nested interpolation in the path
            path_expr = expr
            if "${" in path_expr:
                path_expr = str(self._resolve_str(path_expr))
            value = get_by_dotted(self.root, path_expr, default=ConfigError)
            if value is ConfigError:
                raise ConfigError(f"Unresolvable interpolation ${{{expr}}}")
            return self.resolve(value)
        finally:
            self._stack.pop()


def resolve_config(cfg: dict, base_dir: str | Path = ".") -> dict:
    """Resolve all interpolations in ``cfg``. ``base_dir`` anchors relative
    ``${from_file:...}`` paths (the reference anchors them at the repo root)."""
    return _Resolver(cfg, Path(base_dir)).resolve(cfg)


def check_mandatory(cfg: Any, path: str = "") -> None:
    if isinstance(cfg, Mapping):
        for k, v in cfg.items():
            check_mandatory(v, f"{path}.{k}" if path else str(k))
    elif isinstance(cfg, list):
        for i, v in enumerate(cfg):
            check_mandatory(v, f"{path}[{i}]")
    elif cfg == MANDATORY:
        raise MissingMandatoryValue(f"Mandatory config value {path} is not set")


def load_config(path: str | Path, base_dir: Optional[str | Path] = None) -> dict:
    """Load a single YAML config file and resolve its interpolations."""
    path = Path(path)
    cfg = load_yaml(path)
    return resolve_config(cfg, base_dir if base_dir is not None else path.parent)


def assemble_config(
    argv: Sequence[str],
    defaults_path: Optional[str | Path] = None,
    base_dir: Optional[str | Path] = None,
) -> dict:
    """Build the final config the way the reference CLI does
    (``main.py:48-80``):

    1. parse CLI dotlist; ``config=FILE`` names the experiment config
    2. load the experiment config file
    3. if training, merge it over the defaults file
    4. merge CLI args over that
    5. resolve ``${...}`` interpolations
    6. re-merge CLI args last so module-specific overrides win over
       sub-configs pulled in by ``${from_file:...}``
    """
    cli = parse_dotlist([a for a in argv if "=" in a])
    cfg_path = cli.pop("config", None)
    if cfg_path is None:
        raise ConfigError("config=<file> is required")
    file_cfg = load_yaml(cfg_path)
    action = cli.get("action", file_cfg.get("action"))
    merged = file_cfg
    if defaults_path is not None and action == "train":
        merged = deep_merge(load_yaml(defaults_path), file_cfg)
    merged = deep_merge(merged, cli)
    if base_dir is None:
        base_dir = Path.cwd()
    resolved = resolve_config(merged, base_dir)
    resolved = deep_merge(resolved, cli)
    resolved["config"] = str(cfg_path)
    return resolved
