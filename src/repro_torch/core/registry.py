"""Model registry: arch id -> ModelConfig (+ tags).

The configs the port serves register themselves on import of
``repro_torch.configs``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from repro_torch.core.config import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}
_TAGS: Dict[str, tuple] = {}


def register(cfg: ModelConfig, tags: Iterable[str] = ()) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch id {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    _TAGS[cfg.name] = tuple(tags)
    return cfg


def get(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs(tag: Optional[str] = None) -> List[str]:
    _ensure_loaded()
    if tag is None:
        return sorted(_REGISTRY)
    return sorted(n for n, t in _TAGS.items() if tag in t)


def _ensure_loaded() -> None:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (self-registers)
