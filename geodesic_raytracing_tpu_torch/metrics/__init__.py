from .base import (
    BASE_CONFIGS,
    Metric,
    MetricConfig,
    REGISTRY,
    diag_metric,
    get_metric,
    list_metrics,
    make_config,
    register,
)

# Importing the catalogue modules populates the registry with the ported
# metrics; any other name is a KeyError from get_metric.
from . import catalogue_exotic, catalogue_kerr, catalogue_simple  # noqa: F401

__all__ = [
    "BASE_CONFIGS",
    "Metric",
    "MetricConfig",
    "REGISTRY",
    "diag_metric",
    "get_metric",
    "list_metrics",
    "make_config",
    "register",
]
