"""ElasticQuota reconcilers, ``nos_tpu/controllers/elasticquota`` for
the port (reference internal/controllers/elasticquota/)."""

from .controller import (
    CompositeElasticQuotaReconciler, ElasticQuotaReconciler,
)

__all__ = ["ElasticQuotaReconciler", "CompositeElasticQuotaReconciler"]
