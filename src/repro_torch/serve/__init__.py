"""Serving layer, its model-free half: the version-keyed ``ResultCache``,
the ``ShapeBucketScheduler`` (per-tenant quotas, weighted-fair drain,
``route_and_group``) and the multi-tenant ``CollectionManager``.

``RetrievalService``, ``serve/engine.py`` (the generation loop) and
the models they embed with are not ported yet (ROADMAP Queue 1,
Slice D); this package exports only what exists.
"""
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.collections import Collection, CollectionManager
from repro_torch.serve.scheduler import (Request, ShapeBucketScheduler,
                                         TenantQuota, route_and_group)

__all__ = ["Collection", "CollectionManager", "Request", "ResultCache",
           "ShapeBucketScheduler", "TenantQuota", "route_and_group"]
