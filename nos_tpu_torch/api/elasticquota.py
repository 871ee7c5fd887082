"""ElasticQuota and CompositeElasticQuota with their validating
webhooks, ``nos_tpu/api/elasticquota.py`` for the port (reference
pkg/api/nos.nebuly.com/v1alpha1/{elasticquota_types.go:29-71,
compositeelasticquota_types.go:29-66, elasticquota_webhook.go:48-97}).

``spec.min`` is guaranteed to the namespace, ``spec.max`` an optional
ceiling (empty: none); a namespace may borrow other quotas' unused min,
which the capacity plugin enforces and reclaims
(``scheduler/capacityscheduling.py``).  At most one ElasticQuota per
namespace, and none in a namespace a CompositeElasticQuota covers.
Quantities are in ``nos.nebuly.com/gpu-memory`` GB
(``quota/calculator.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from nos_tpu_torch.api.constants import (
    KIND_COMPOSITE_ELASTIC_QUOTA, KIND_ELASTIC_QUOTA,
)
from nos_tpu_torch.kube.objects import FastCopy, ObjectMeta
from nos_tpu_torch.kube.resources import ResourceList


@dataclass
class ElasticQuotaSpec(FastCopy):
    min: ResourceList = field(default_factory=dict)
    max: ResourceList = field(default_factory=dict)


@dataclass
class ElasticQuotaStatus(FastCopy):
    used: ResourceList = field(default_factory=dict)


@dataclass
class ElasticQuota(FastCopy):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ElasticQuotaSpec = field(default_factory=ElasticQuotaSpec)
    status: ElasticQuotaStatus = field(default_factory=ElasticQuotaStatus)

    @property
    def namespaces(self) -> list[str]:
        """An ElasticQuota governs its own namespace."""
        return [self.metadata.namespace]


@dataclass
class CompositeElasticQuotaSpec(FastCopy):
    namespaces: list[str] = field(default_factory=list)
    min: ResourceList = field(default_factory=dict)
    max: ResourceList = field(default_factory=dict)


@dataclass
class CompositeElasticQuota(FastCopy):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CompositeElasticQuotaSpec = field(
        default_factory=CompositeElasticQuotaSpec)
    status: ElasticQuotaStatus = field(default_factory=ElasticQuotaStatus)

    @property
    def namespaces(self) -> list[str]:
        return list(self.spec.namespaces)


class AdmissionError(Exception):
    """A webhook's denial."""


def install_quota_webhooks(api) -> None:
    """Register both validating webhooks on the API server (the
    operator's main does this at boot, reference
    cmd/operator/operator.go:50-126)."""
    api.register_admission(KIND_ELASTIC_QUOTA, validate_elastic_quota)
    api.register_admission(KIND_COMPOSITE_ELASTIC_QUOTA,
                           validate_composite_elastic_quota)


def validate_elastic_quota(api, eq: ElasticQuota) -> None:
    """At most one ElasticQuota per namespace, and none in a namespace a
    CompositeElasticQuota covers."""
    ns = eq.metadata.namespace
    for other in api.list(KIND_ELASTIC_QUOTA, namespace=ns):
        if other.metadata.name != eq.metadata.name:
            raise AdmissionError(
                f"namespace {ns!r} already has ElasticQuota "
                f"{other.metadata.name!r}; only one is allowed")
    for ceq in api.list(KIND_COMPOSITE_ELASTIC_QUOTA):
        if ns in ceq.spec.namespaces:
            raise AdmissionError(
                f"namespace {ns!r} is governed by CompositeElasticQuota "
                f"{ceq.metadata.name!r}; an ElasticQuota may not overlap")


def validate_composite_elastic_quota(api, ceq: CompositeElasticQuota) -> None:
    """At least one namespace, none covered by another
    CompositeElasticQuota.  An overlapping plain ElasticQuota is not
    denied here: the composite's reconciler deletes it (reference
    compositeelasticquota_controller.go:112-137)."""
    if not ceq.spec.namespaces:
        raise AdmissionError(
            "spec.namespaces must contain at least one namespace")
    for other in api.list(KIND_COMPOSITE_ELASTIC_QUOTA):
        if other.metadata.name == ceq.metadata.name and \
                other.metadata.namespace == ceq.metadata.namespace:
            continue
        overlap = set(other.spec.namespaces) & set(ceq.spec.namespaces)
        if overlap:
            raise AdmissionError(
                f"namespaces {sorted(overlap)} already governed by "
                f"CompositeElasticQuota {other.metadata.name!r}")
