"""Elastic-quota bookkeeping, ``nos_tpu/quota`` for the port: the
``nos.nebuly.com/gpu-memory`` currency and the quota ledger (reference
pkg/gpu/util/resource.go, pkg/scheduler/plugins/capacityscheduling/
elasticquotainfo.go)."""

from .calculator import GPUResourceCalculator
from .info import (
    ElasticQuotaInfo, ElasticQuotaInfos, greater_than, sum_greater_than,
)

__all__ = [
    "GPUResourceCalculator", "ElasticQuotaInfo", "ElasticQuotaInfos",
    "greater_than", "sum_greater_than",
]
