"""Layered YAML config system: ``load_cfg`` and its dotted overrides.

Port of ``esrnerf_tpu/config.py`` (the port keeps its own copy), reading
the shared ``cfg/`` tree as it is. A minimal, dependency-free re-implementation of the Hydra composition
semantics the reference relies on (reference: ``run.py:21``,
``cfg/__init__.yaml``, ``utils2/manager.py:17-130``):

- every YAML may declare a ``defaults`` list; entries are merged in order,
  with ``_self_`` marking where the file's own content merges;
- entry names resolve relative to the file's directory, or from the repo
  root when absolute (``/cfg/app/alphamask``);
- ``${a.b.c}`` interpolations and the ``${now:<strftime>}`` resolver;
- ``???`` marks mandatory values that must be filled by a higher layer;
- CLI dot-overrides (``app.phase=train``) applied after composition;
- the resolved config is re-saved into the log dir (:func:`save_cfg`) so
  that a log-dir ``cfg.yaml`` is itself a runnable config.

Configs compose to a plain nested dict wrapped in :class:`Config` for
attribute access.
"""

from __future__ import annotations

import copy
import datetime
import os
import re
from typing import Any, Dict, List, Optional

import yaml

MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class Config(dict):
    """Nested dict with attribute access. ``cfg.app.trainer.lrs.density``."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if v == MISSING:
            raise ValueError(f"config key '{name}' is mandatory ('???') but unset")
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Dict[str, Any] = self
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = Config()
                node[part] = nxt
            node = nxt
        node[parts[-1]] = value

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def to_dict(self) -> Dict[str, Any]:
        return _unwrap(self)


def _wrap(node: Any) -> Any:
    if isinstance(node, dict):
        return Config({k: _wrap(v) for k, v in node.items()})
    if isinstance(node, list):
        return [_wrap(v) for v in node]
    return node


def _unwrap(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _unwrap(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_unwrap(v) for v in node]
    return node


def _merge(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    """Deep merge src into dst (src wins; dicts merge recursively)."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return data or {}


def _resolve_ref(ref: str, cur_dir: str, root_dir: str) -> str:
    ref = ref.strip()
    if ref.startswith("/"):
        path = os.path.join(root_dir, ref.lstrip("/"))
    else:
        path = os.path.join(cur_dir, ref)
    if not path.endswith((".yaml", ".yml")):
        path = path + ".yaml"
    return path


def _compose(path: str, root_dir: str, _seen: Optional[set] = None) -> Dict[str, Any]:
    # _seen is shared across the whole composition (Hydra semantics: each
    # config file contributes exactly once, at its first position in the
    # defaults tree) — otherwise a root config reachable via two paths would
    # re-merge its '???' placeholders over earlier scene/stage values.
    if _seen is None:
        _seen = set()
    apath = os.path.abspath(path)
    if apath in _seen:
        return {}
    _seen.add(apath)

    content = _load_yaml(path)
    defaults: List[Any] = content.pop("defaults", ["_self_"])
    if "_self_" not in defaults:
        defaults = defaults + ["_self_"]

    out: Dict[str, Any] = {}
    cur_dir = os.path.dirname(apath)
    for entry in defaults:
        if isinstance(entry, dict):
            # hydra group overrides (e.g. "override /hydra/...": none) — no-op
            continue
        if entry == "_self_":
            _merge(out, content)
        elif "__hydra__" in entry or entry.startswith("override"):
            continue
        else:
            sub = _resolve_ref(entry, cur_dir, root_dir)
            _merge(out, _compose(sub, root_dir, _seen))
    return out


def _interpolate(cfg: Dict[str, Any]) -> None:
    """Resolve ${a.b} and ${now:fmt} string interpolations in place."""
    now = datetime.datetime.now()

    def resolve_str(s: str) -> Any:
        def repl(m: "re.Match[str]") -> str:
            expr = m.group(1)
            if expr.startswith("now:"):
                return now.strftime(expr[4:])
            node: Any = cfg
            for part in expr.split("."):
                if not isinstance(node, dict) or part not in node:
                    raise KeyError(f"interpolation '${{{expr}}}' not found")
                node = node[part]
            return str(node)

        prev = None
        while prev != s and isinstance(s, str) and "${" in s:
            prev = s
            s = _INTERP_RE.sub(repl, s)
        return s

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            for k, v in node.items():
                node[k] = walk(v)
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str) and "${" in node:
            return resolve_str(node)
        return node

    walk(cfg)


def _parse_override_value(raw: str) -> Any:
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def load_cfg(
    config_name: str,
    overrides: Optional[List[str]] = None,
    root_dir: Optional[str] = None,
) -> Config:
    """Compose a config from a YAML path plus CLI dot-overrides.

    ``config_name`` is a path (relative to ``root_dir``, default CWD) to a
    YAML file, matching the reference's ``python run.py -cn <cfg>`` usage.
    """
    root_dir = os.path.abspath(root_dir or os.getcwd())
    path = config_name
    if not os.path.isabs(path):
        path = os.path.join(root_dir, path)
    if not path.endswith((".yaml", ".yml")) and not os.path.exists(path):
        path = path + ".yaml"

    raw = _compose(path, root_dir)
    cfg = _wrap(raw)
    cfg["__config_name__"] = os.path.relpath(path, root_dir)

    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' must look like key.path=value")
        key, _, val = ov.partition("=")
        cfg.set_path(key.strip(), _wrap(_parse_override_value(val)))

    _interpolate(cfg)
    return cfg


def missing_keys(cfg: Dict[str, Any], prefix: str = "") -> List[str]:
    """List every dotted path still set to '???'."""
    out: List[str] = []
    for k, v in cfg.items():
        dotted = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(missing_keys(v, dotted))
        elif v == MISSING:
            out.append(dotted)
    return out


def save_cfg(cfg: Config, path: Optional[str] = None) -> str:
    """Write the resolved config into the log dir (``cfg.yaml``) so that the
    log-dir config is itself runnable."""
    if path is None:
        path = os.path.join(cfg.log.dir, "cfg.yaml")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = _unwrap(cfg)
    data.pop("__config_name__", None)
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
    return path


def customize_cfg(cfg: Config) -> Config:
    """Fill derived fields: log dirs, phase check, debug redirection.
    ``log.dir`` = ``<root>/info/<project>/<group>/<name>/<phase>`` and
    ``log.ckpt_dir`` = ``<root>/ckpt/<project>/<group>/<name>``."""
    if cfg.get_path("system.debug"):
        cfg.log["project"] = "debug"

    phase = cfg.app["phase"]
    valid = {"train", "test_nv", "test_nvc", "test_nvi", "test_nvic"}
    if phase not in valid:
        raise ValueError(f"unknown phase '{phase}', expected one of {sorted(valid)}")

    if not cfg.log.get("dir"):
        cfg.log["dir"] = os.path.join(
            cfg.log["root"], "info", cfg.log["project"], cfg.log["group"],
            cfg.log["name"], phase,
        )
    if not cfg.log.get("ckpt_dir"):
        cfg.log["ckpt_dir"] = os.path.join(
            cfg.log["root"], "ckpt", cfg.log["project"], cfg.log["group"],
            cfg.log["name"],
        )
    return cfg
