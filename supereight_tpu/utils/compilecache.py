"""Persistent XLA compilation cache.

The fused frame step is one large XLA program, and a cold compile of it
takes far longer than a frame. The reference has no equivalent cost
(C++ is compiled once, ahead of time); the persistent cache restores
that property: the first run of an entry point compiles and stores its
executables, later runs load them.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that
directory and :func:`enable` sets none. Otherwise the cache lives at the
fixed path ``<repo>/.jax_cache`` (a fixed path, because the path is part
of the cache key). Call :func:`enable` before the first jit dispatch.
"""

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable() -> str:
    """Turn the cache on; returns the directory it uses."""
    import jax
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env_dir:
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return env_dir or DEFAULT_DIR
