"""Hydra-style YAML config composition, dependency-free.

The port's copy of ``sheeprl_tpu/config/compose.py`` (it imports nothing of
the JAX package); ``compose`` reads this package's own ``configs/`` tree.

The reference framework drives everything through Hydra (+OmegaConf):
a root ``config.yaml`` with a ``defaults`` list, config *groups*
(``algo/``, ``env/``, ``exp/``, ...), ``${...}`` interpolation, dotted
CLI overrides and ``_target_`` object instantiation
(see reference sheeprl/configs/config.yaml and sheeprl/cli.py:358).

Neither hydra nor omegaconf is available here, so this module
re-implements the subset the framework needs:

- ``defaults`` lists with ``_self_``, ``group: option``,
  ``override /group: option`` and ``/group@package: option`` entries;
- ``# @package _global_`` headers (group file merges at the root);
- deep-merge composition, later wins;
- lazy ``${a.b.c}`` interpolation + ``${now:%fmt}`` resolver;
- CLI overrides: ``group=option`` (when ``group/option.yaml`` exists),
  ``a.b.c=value`` (yaml-parsed scalar), ``+a.b=v`` to add new keys,
  ``~a.b`` to delete;
- ``???`` required-value markers, validated on access.

The JAX package's environment resolvers (``oc.env``, ``eval``), its
``SHEEPRL_SEARCH_PATH`` and its package-qualified CLI selections
(``group@package=option``) are left out: no config of this slice uses them.
"""

from __future__ import annotations

import copy
import datetime
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")
_YAML_FLOAT_RE = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_loader = None


def _yaml_loader():
    """SafeLoader that also parses ``1e-3``-style floats (YAML 1.2 rule).
    PyYAML is imported here, on first use, so that code which only needs
    :class:`dotdict` (``chip_smoke.py``) runs where PyYAML is absent."""
    global _loader
    if _loader is None:
        import yaml

        class _YamlLoader(yaml.SafeLoader):
            pass

        _YamlLoader.add_implicit_resolver("tag:yaml.org,2002:float", _YAML_FLOAT_RE, list("-+0123456789."))
        _loader = _YamlLoader
    return _loader


def yaml_load(text: str) -> Any:
    import yaml

    return yaml.load(text, Loader=_yaml_loader())  # noqa: S506


class ConfigError(Exception):
    pass


class MissingValueError(ConfigError):
    pass


# --------------------------------------------------------------------------- #
# dotdict: attribute access over nested dicts (reference utils/utils.py:34)
# --------------------------------------------------------------------------- #
class dotdict(dict):
    """dict with attribute access, recursively applied to nested dicts."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if isinstance(v, dict) and not isinstance(v, dotdict):
                self[k] = dotdict(v)
            elif isinstance(v, list):
                self[k] = [dotdict(x) if isinstance(x, dict) and not isinstance(x, dotdict) else x for x in v]

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if v == MISSING:
            raise MissingValueError(f"Missing required config value: '{name}' is '???'")
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = dotdict(value) if isinstance(value, dict) and not isinstance(value, dotdict) else value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return dotdict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def as_dict(self) -> dict:
        def conv(v):
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return conv(self)


# --------------------------------------------------------------------------- #
# merging / path helpers
# --------------------------------------------------------------------------- #
def deep_merge(dst: dict, src: dict) -> dict:
    """Merge ``src`` into ``dst`` (in place), later wins; dicts recurse."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _set_path(cfg: dict, path: str, value: Any) -> None:
    keys = path.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def _get_path(cfg: dict, path: str) -> Any:
    node: Any = cfg
    for k in path.split("."):
        if isinstance(node, (list, tuple)):
            node = node[int(k)]
        elif isinstance(node, dict):
            node = node[k]
        else:
            raise KeyError(path)
    return node


def _del_path(cfg: dict, path: str) -> None:
    keys = path.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node[k]
    del node[keys[-1]]


# --------------------------------------------------------------------------- #
# interpolation
# --------------------------------------------------------------------------- #
def _resolve_value(expr: str, root: dict, stack: Tuple[str, ...]) -> Any:
    expr = expr.strip()
    if expr.startswith("now:"):
        return datetime.datetime.now().strftime(expr[4:])
    if expr in stack:
        raise ConfigError(f"Interpolation cycle at '${{{expr}}}' via {stack}")
    try:
        val = _get_path(root, expr)
    except (KeyError, IndexError, ValueError) as e:
        raise ConfigError(f"Interpolation '${{{expr}}}' not found") from e
    return _resolve_node(val, root, stack + (expr,))


def _resolve_node(val: Any, root: dict, stack: Tuple[str, ...] = ()) -> Any:
    if isinstance(val, str):
        m = _INTERP_RE.fullmatch(val.strip())
        if m:  # whole-string interpolation preserves type
            return _resolve_value(m.group(1), root, stack)

        def sub(match: "re.Match[str]") -> str:
            return str(_resolve_value(match.group(1), root, stack))

        out, n = _INTERP_RE.subn(sub, val)
        # handle nested ${a${b}} by iterating until fixpoint (bounded)
        for _ in range(10):
            if not _INTERP_RE.search(out):
                break
            out2 = _INTERP_RE.sub(sub, out)
            if out2 == out:
                break
            out = out2
        return out
    return val


def resolve(cfg: dict, root: Optional[dict] = None) -> dict:
    """Recursively resolve all interpolations; returns a new tree."""
    root = root if root is not None else cfg

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return _resolve_node(node, root)

    return walk(cfg)


# --------------------------------------------------------------------------- #
# composition engine
# --------------------------------------------------------------------------- #
class Composer:
    """Compose a config tree from a config dir, hydra-defaults style."""

    def __init__(self, config_dirs: Sequence[Path]):
        self.config_dirs = [Path(d) for d in config_dirs]
        self._cli_keys: set = set()
        self._load_cache: Dict[str, Tuple[dict, str]] = {}

    # -- file loading ------------------------------------------------------ #
    def _find(self, rel: str) -> Optional[Path]:
        rel = rel if rel.endswith((".yaml", ".yml")) else rel + ".yaml"
        for d in self.config_dirs:
            p = d / rel
            if p.exists():
                return p
        return None

    def _load(self, rel: str) -> Tuple[dict, str]:
        """Return (raw-yaml-dict, package-directive). Parses each file once
        per composer (the two composition passes re-read files); callers get
        a fresh deep copy since composition mutates the dict (defaults pop,
        merges)."""
        if rel not in self._load_cache:
            p = self._find(rel)
            if p is None:
                raise ConfigError(
                    f"Config file '{rel}' not found in {[str(d) for d in self.config_dirs]}"
                )
            text = p.read_text()
            pkg = "_group_"
            for line in text.splitlines()[:5]:
                m = re.match(r"#\s*@package\s+(\S+)", line.strip())
                if m:
                    pkg = m.group(1)
                    break
            data = yaml_load(text) or {}
            if not isinstance(data, dict):
                raise ConfigError(f"Config file '{rel}' must contain a mapping")
            self._load_cache[rel] = (data, pkg)
        data, pkg = self._load_cache[rel]
        return copy.deepcopy(data), pkg

    # -- defaults handling ------------------------------------------------- #
    @staticmethod
    def _parse_default(entry: Any) -> Tuple[str, Optional[str], bool]:
        """Normalize a defaults entry -> (group_expr, option, is_override)."""
        if isinstance(entry, str):
            return entry, None, False
        if isinstance(entry, dict) and len(entry) == 1:
            (key, option), = entry.items()
            key = str(key).strip()
            is_override = False
            if key.startswith("override "):
                is_override = True
                key = key[len("override "):].strip()
            return key, (None if option is None else str(option)), is_override
        raise ConfigError(f"Bad defaults entry: {entry!r}")

    def _compose_file(
        self,
        rel: str,
        group_prefix: str,
        selections: Dict[str, str],
    ) -> Tuple[dict, str]:
        """Compose one file with its own defaults list. Returns (tree, pkg)."""
        data, pkg = self._load(rel)
        defaults = data.pop("defaults", None)
        own = data  # content of the file itself (post-defaults-pop)

        if defaults is None:
            return copy.deepcopy(own), pkg

        result: dict = {}
        self_merged = False
        for entry in defaults:
            group_expr, option, is_override = self._parse_default(entry)
            if group_expr == "_self_":
                deep_merge(result, own)
                self_merged = True
                continue
            if option is None and not is_override:
                # bare string entry: include a sibling file of the same group
                # (e.g. `- default` inside algo/ppo.yaml -> algo/default.yaml)
                inc = f"{group_prefix}/{group_expr}" if group_prefix else group_expr
                sub_tree, _ = self._compose_file(inc, group_prefix, selections)
                deep_merge(result, sub_tree)
                continue
            if is_override:
                # overrides re-select a previously chosen group option; they
                # take effect on the second composition pass (CLI wins)
                key = group_expr.lstrip("/")
                if key not in self._cli_keys:
                    selections[key] = option or ""
                continue

            # group@package syntax
            if "@" in group_expr:
                group, package = group_expr.split("@", 1)
            else:
                group, package = group_expr, None
            group = group.strip()
            absolute = group.startswith("/")
            group_path = group.lstrip("/") if absolute else (
                f"{group_prefix}/{group}" if group_prefix else group
            )
            group_key = group.lstrip("/")
            # CLI/override selection beats the file's default option
            chosen = selections.get(group_key, option)
            if chosen in (None, ""):
                chosen = option
            if chosen == MISSING or chosen is None:
                if group_key in selections and selections[group_key] not in (None, "", MISSING):
                    chosen = selections[group_key]
                else:
                    raise ConfigError(
                        f"You must specify '{group_key}=<option>' (required group, e.g. 'exp=ppo')"
                    )
            chosen = str(chosen)
            if chosen.endswith((".yaml", ".yml")):
                chosen = chosen.rsplit(".", 1)[0]
            sub_rel = f"{group_path}/{chosen}"
            sub_tree, sub_pkg = self._compose_file(sub_rel, group_path, selections)
            if package is not None:
                mount = None if package == "_global_" else package
            elif sub_pkg == "_global_":
                mount = None
            else:
                mount = group_key.replace("/", ".")
            if mount is None:
                deep_merge(result, sub_tree)
            else:
                node = result
                for part in mount.split("."):
                    node = node.setdefault(part, {})
                deep_merge(node, sub_tree)
        if not self_merged:
            deep_merge(result, own)
        return result, pkg


def _parse_cli_value(raw: str) -> Any:
    import yaml

    try:
        return yaml_load(raw)
    except yaml.YAMLError:
        return raw


def compose(
    config_name: str = "config",
    overrides: Optional[Sequence[str]] = None,
    config_dirs: Optional[Sequence[str]] = None,
    do_resolve: bool = True,
) -> dotdict:
    """Compose the full config. Equivalent of @hydra.main + OmegaConf.resolve.

    ``overrides`` accepts hydra-style strings: ``exp=dreamer_v3``,
    ``algo.total_steps=1024``, ``+extra.key=1``, ``~metric.aggregator``.
    ``config_dirs`` are searched before this package's own ``configs/``.
    """
    overrides = list(overrides or [])
    dirs: List[Path] = [Path(d) for d in (config_dirs or [])]
    default_dir = Path(__file__).resolve().parent.parent / "configs"
    if default_dir not in dirs:
        dirs.append(default_dir)

    composer = Composer(dirs)

    # split overrides into group selections vs value sets
    selections: Dict[str, str] = {}
    sets: List[Tuple[str, Any]] = []
    adds: List[Tuple[str, Any]] = []
    dels: List[str] = []
    for ov in overrides:
        if ov.startswith("~"):
            dels.append(ov[1:])
            continue
        if "=" not in ov:
            raise ConfigError(f"Bad override '{ov}' (expected key=value)")
        key, raw = ov.split("=", 1)
        add = key.startswith("+")
        key = key.lstrip("+")
        # group selection iff a matching option file exists
        if "." not in key and composer._find(f"{key}/{raw}") is not None:
            selections[key] = raw
            continue
        (adds if add else sets).append((key, _parse_cli_value(raw)))

    # Two passes: pass 1 walks the defaults tree so nested `override /group:`
    # entries (e.g. in exp files) land in `selections`; pass 2 composes with
    # the final selection map. CLI selections always win.
    composer._cli_keys = set(selections)
    composer._compose_file(config_name, "", selections)
    tree, _ = composer._compose_file(config_name, "", selections)
    for key, val in sets + adds:
        _set_path(tree, key, val)
    for key in dels:
        try:
            _del_path(tree, key)
        except KeyError:
            pass
    if do_resolve:
        tree = resolve(tree)
    return dotdict(tree)
