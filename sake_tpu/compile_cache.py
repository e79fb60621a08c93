"""Persistent XLA compilation cache, shared by every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and nothing
here overrides it. Otherwise the cache lives at ``<repo>/.jax_cache``: a
fixed path, so a later process on the same checkout finds what an earlier
one compiled.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``.
    Call before the first compilation; returns the directory."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
