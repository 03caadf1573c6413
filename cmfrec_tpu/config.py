"""Global configuration helpers for cmfrec-tpu.

The reference library selects float32/float64 at compile time (``USE_FLOAT``,
/root/reference/src/cmfrec.h:232-313) and exposes it per-model as
``use_float``.  Here dtype is a per-model runtime choice; float32 is the
default, float64 requires ``jax.config.update("jax_enable_x64", True)``
(done lazily when a model requests it).
"""

from __future__ import annotations

import os

import jax
import numpy as np

# Default matmul precision for solver einsums.  On the GPU a float32 matmul
# at DEFAULT precision runs in TF32 (about three decimal digits); "highest"
# keeps it in full float32, which is required to match the reference's
# float64-ish RMSE trajectories.
SOLVER_PRECISION = jax.lax.Precision.HIGHEST

# Row-block granularity: padded bucket row counts are multiples of this so
# the number of distinct compiled shapes stays small and blocks shard evenly
# over a device mesh.
DEFAULT_ROW_BLOCK = 8

# Cap on R*L elements a single gathered [R, L, K] block may have before the
# data layer splits a bucket into several chunks (bounds peak device memory
# of the gathered opposing-factor slab: 2**23 * 56 coords * 2B bf16 ~ 0.9GB).
DEFAULT_MAX_BLOCK_ELEMS = 1 << 23

# Dense engines: the share of the device's memory limit their resident
# [m, n] forms may take (the rest holds factors, CG temporaries and the
# compiled programs), and the fixed budget used on the CPU.
DENSE_BUDGET_FRACTION = 0.5
_CPU_DENSE_BUDGET_GB = 6.5

# Checkout root: the default home of the persistent compilation cache.
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def on_accelerator() -> bool:
    """Whether the default backend is a GPU.  Every fast-path gate (the
    fused dense engines, bf16 operands, device-side bucket fill, one jit
    per collective iteration) reads this; the CPU keeps the plain engines
    the tests pin."""
    return jax.default_backend() == "gpu"


def dense_budget_bytes() -> int:
    """Bytes the dense engines' resident forms may take.

    ``CMFREC_TPU_DENSE_BUDGET_GB`` overrides.  Otherwise, on the GPU it is
    DENSE_BUDGET_FRACTION of the first device's ``bytes_limit`` (what the
    allocator may hand out), and a fixed 6.5 GB on the CPU."""
    env = os.environ.get("CMFREC_TPU_DENSE_BUDGET_GB")
    if env is not None:
        return int(float(env) * (1 << 30))
    if on_accelerator():
        limit = jax.devices()[0].memory_stats()["bytes_limit"]
        return int(DENSE_BUDGET_FRACTION * limit)
    return int(_CPU_DENSE_BUDGET_GB * (1 << 30))


def resolve_dtype(use_float: bool | str | np.dtype) -> np.dtype:
    """Map the reference's ``use_float`` flag (or a dtype-ish) to a numpy dtype."""
    if isinstance(use_float, (bool, np.bool_)):
        dtype = np.float32 if use_float else np.float64
    else:
        dtype = np.dtype(use_float).type
    if dtype == np.float64 and not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    return np.dtype(dtype)


def exact_dense_enabled() -> bool:
    """Whether use_cg=False ("Cholesky") fits may ride the fused masked
    engine in exact mode on the GPU (CG run to the per-row 1e-8 freeze
    under the Krylov step cap — the same per-row systems solved to the f32
    fixed point at matvec cost instead of the bucketed engine's nnz*k^2
    Gram assembly).  CMFREC_TPU_NO_EXACT_DENSE=1 keeps exact fits on the
    per-row-Cholesky bucketed engine."""
    return os.environ.get("CMFREC_TPU_NO_EXACT_DENSE", "0") != "1"


def enable_persistent_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here.  Otherwise the cache goes to ``.jax_cache/``
    at the checkout root (a fixed path, so that reruns hit it), and every
    program is persisted: a cold fit compiles a few hundred small helper
    programs besides the iteration program."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_CHECKOUT, ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


# ----------------------------------------------------------------------- #
# interrupt handling (the reference's handle_interrupt flag,               #
# /root/reference/src/helpers.c:1493 act_on_interrupt)                     #
# ----------------------------------------------------------------------- #

_HANDLE_INTERRUPT = True


def set_handle_interrupt(flag: bool) -> bool:
    """Set whether fit loops catch SIGINT and return the partial model
    (True, reference default) or re-raise (False).  Returns the old value."""
    global _HANDLE_INTERRUPT
    old = _HANDLE_INTERRUPT
    _HANDLE_INTERRUPT = bool(flag)
    return old


def should_handle_interrupt() -> bool:
    return _HANDLE_INTERRUPT
