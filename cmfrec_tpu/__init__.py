"""cmfrec_tpu — collective matrix factorization in JAX, for NVIDIA GPUs.

A brand-new JAX/XLA implementation of the cmfrec model zoo (explicit and
implicit collective matrix factorization, offsets/content-based cold-start
models, most-popular baseline), with batched ALS on bucketed sparse shards
instead of per-row CPU loops.  See SURVEY.md for the design blueprint and
the reference feature inventory.
"""

from .models.cmf import CMF, CMF_implicit

__all__ = [
    "CMF",
    "CMF_implicit",
]

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy imports keep the base import light and tolerate models that are
    # still being built out in later rounds.
    if name in ("OMF_explicit", "OMF_implicit", "ContentBased"):
        from .models import omf

        return getattr(omf, name)
    if name == "MostPopular":
        from .models.most_popular import MostPopular

        return MostPopular
    if name == "CMF_imputer":
        from .models.imputer import CMF_imputer

        return CMF_imputer
    raise AttributeError(name)
