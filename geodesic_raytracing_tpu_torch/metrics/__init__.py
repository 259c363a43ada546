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
from . import (  # noqa: F401
    catalogue_exotic, catalogue_kerr, catalogue_multibody, catalogue_simple)

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
