"""JSON (de)serialisation of the cluster object model,
``nos_tpu/kube/serialize.py`` for the port.

All durable control-plane state lives in the API server, so
``dump_state`` of its stores is the control plane's checkpoint format
and ``load_state`` rebuilds an in-memory server from it.  The objects are
plain nested dataclasses (``kube/objects.py``, ``api/*``): the codec is
``dataclasses.asdict`` out and a field-typed construction back in.
Unknown keys are ignored and unknown kinds skipped with a warning, so a
dump from a newer build still loads the kinds this one knows.
"""

from __future__ import annotations

import dataclasses
import logging
import typing
from typing import Any

from nos_tpu_torch.api.elasticquota import CompositeElasticQuota, ElasticQuota
from nos_tpu_torch.api.pdb import PodDisruptionBudget
from nos_tpu_torch.api.podgroup import PodGroup
from nos_tpu_torch.kube.client import (
    APIServer, KIND_COMPOSITE_ELASTIC_QUOTA, KIND_CONFIGMAP,
    KIND_ELASTIC_QUOTA, KIND_NODE, KIND_POD, KIND_POD_DISRUPTION_BUDGET,
    KIND_POD_GROUP,
)
from nos_tpu_torch.kube.objects import ConfigMap, Node, Pod

logger = logging.getLogger(__name__)

KIND_TYPES: dict[str, type] = {
    KIND_POD: Pod,
    KIND_NODE: Node,
    KIND_CONFIGMAP: ConfigMap,
    KIND_ELASTIC_QUOTA: ElasticQuota,
    KIND_COMPOSITE_ELASTIC_QUOTA: CompositeElasticQuota,
    KIND_POD_GROUP: PodGroup,
    KIND_POD_DISRUPTION_BUDGET: PodDisruptionBudget,
}


def _build(cls: type, data: Any) -> Any:
    """Construct ``cls`` from plain JSON data through the dataclass field
    types; missing keys take their defaults, unknown keys are ignored."""
    if data is None:
        return None
    origin = typing.get_origin(cls)
    if origin in (list, tuple):
        (item_t,) = typing.get_args(cls)[:1] or (Any,)
        seq = [_build(item_t, v) for v in data]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        return dict(data)
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(cls) if a is not type(None)]
        return _build(args[0], data) if args else data
    if dataclasses.is_dataclass(cls):
        if not isinstance(data, dict):
            # a string would pass the field lookups below and yield a
            # default object: corrupt input must fail loudly
            raise ValueError(
                f"expected object for {cls.__name__}, got {type(data).__name__}")
        hints = typing.get_type_hints(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in data:
                kwargs[f.name] = _build(hints.get(f.name, Any), data[f.name])
        return cls(**kwargs)
    return data


def to_dict(obj: Any) -> Any:
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


def from_dict(kind: str, data: dict) -> Any:
    cls = KIND_TYPES.get(kind)
    return _build(cls, data) if cls is not None else data


def dump_state(api) -> dict:
    """{kind: [object dicts]} for every populated store.  The known kinds
    are listed one by one (over REST, ``kinds()`` would list them all
    once more); an in-memory server adds any other kind it holds."""
    out: dict[str, list] = {}
    kinds = set(KIND_TYPES)
    if isinstance(api, APIServer):
        kinds |= set(api.kinds())
    for kind in sorted(kinds):
        objs = api.list(kind)
        if objs:
            out[kind] = [to_dict(o) for o in objs]
    return out


def load_state(data: dict, api: APIServer | None = None) -> APIServer:
    """An APIServer rebuilt from ``dump_state``'s output; admission does
    not run again (the dump holds admitted state)."""
    api = api or APIServer()
    for kind, objs in data.items():
        if kind not in KIND_TYPES:
            logger.warning("load_state: skipping unknown kind %r "
                           "(%d object(s))", kind, len(objs))
            continue
        for obj in objs:
            api.create(kind, from_dict(kind, obj))
    return api
