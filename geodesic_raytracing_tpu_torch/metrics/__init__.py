from .base import (
    BASE_CONFIGS,
    Metric,
    MetricConfig,
    REGISTRY,
    get_metric,
    list_metrics,
    make_config,
    register,
)

# Importing the catalogue module populates the registry.  Only kerr_boyer is
# ported so far; any other name is a KeyError from get_metric.
from . import catalogue_kerr  # noqa: F401

__all__ = [
    "BASE_CONFIGS",
    "Metric",
    "MetricConfig",
    "REGISTRY",
    "get_metric",
    "list_metrics",
    "make_config",
    "register",
]
